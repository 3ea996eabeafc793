"""One run of one cell: set-up, the measured window, the drain, the
metrics and the correctness check.

Phases:

1. set-up (``setup_s``, process start → window opening): the kernels
   loaded from the checkout's build cache (built there on first use),
   the weights and adapters drawn on the device from the seed, the
   ``Engine`` built with the configuration's and cell's settings, and a
   ramp of the cell's own traffic for ``ramp_s`` seconds, so that the
   window opens on a steady system;
2. the window (``--seconds``): open-loop arrivals from the cell's mix at
   the cell's rate;
3. the drain: arrivals go on at the same rate until every request due
   in the window has finished, or ``drain_cap_s`` has passed (those
   left count as failed).

Then the peak memory is read, the engine is freed, and the reference
scores a sample of the window's finished requests.  ``--trace 0`` runs
the engine with ``EngineConfig(trace=False)`` and reports the cell's
end-to-end metrics; ``--trace 1`` runs it traced, instruments it
(``tracing.Recorder``) and reports the per-layer metrics.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from alora_bench import correctness, profile_read, spec as S
from alora_bench.driver import Driver
from alora_bench.stats import finite_or_none
from alora_bench.tracing import Recorder

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SAMPLE_TOKENS = 320
SAMPLE_REQUESTS = 16
PROFILE_STEPS = 16
PROFILE_AT = 0.4          # share of the window before the profiled steps


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class Record:
    """What the metric readers read (``metrics/<name>.py``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (or ``names``) whose top-level name is JAX's,
    Flax's or the JAX package's, compared whole."""
    tops = {n.split(".")[0] for n in (list(sys.modules) if names is None
                                      else names)}
    return sorted(tops & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def build_engine(spec: S.CellSpec, cfg, w: Dict[str, Any], trace: bool,
                 device):
    from repro_torch.core.alora import AdapterSpec
    from repro_torch.serving.engine import Engine, EngineConfig
    ecfg = EngineConfig(**spec.engine, trace=trace)
    ads = [(AdapterSpec(name, spec.config["adapters"]["rank"], ids), tree)
           for name, ids, tree in w["adapters"]]
    return Engine(cfg, w["params"], engine_cfg=ecfg, adapters=ads,
                  device=device)


def traffic(spec: S.CellSpec, dims, w, seed: int, rate: float):
    V = dims["vocab_size"]
    n_reserved = len(w["adapters"]) * spec.config["adapters"][
        "invocation_tokens"]
    make = S.generator(spec)
    return make(spec.mix, seed=seed, rate=rate, vocab=(1, V - n_reserved),
                invocations=[ids for _, ids, _ in w["adapters"]])


def prepare(workload: str, seed: int, device: str, root: Path = S.ROOT,
            overrides: Optional[Dict] = None, reduced: bool = False):
    """The cell's spec, the port's configuration, its plain numbers and
    the weights drawn from ``seed``, each from the cell's model family;
    on a card, the kernels loaded (and built on first use) first."""
    from repro_torch.models.model import period_segments
    spec = S.load(workload, root, overrides)
    dev = torch.device(device)
    fam = spec.family
    cfg = fam.config(spec, reduced)
    dims = fam.dims_of(cfg)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.load()
        torch.cuda.reset_peak_memory_stats()
    w = fam.draw(dims, spec.config["adapters"], seed, dev,
                 period_segments(cfg))
    return spec, cfg, dims, w


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: Optional[float] = None, device: str = "cuda",
        root: Path = S.ROOT, overrides: Optional[Dict] = None,
        reduced: bool = False, control: bool = False):
    """One run; returns the result line's object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``[, ``breakdown``],
    ``checks`` last) and the window's samples (per-request first-token
    times, every inter-token gap) for the summary file."""
    t_start = time.perf_counter() if t_start is None else t_start
    from repro_torch.serving.request import State

    spec, cfg, dims, w = prepare(workload, seed, device, root, overrides,
                                 reduced)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    eng = build_engine(spec, cfg, w, trace, dev)
    rate = spec.rate
    drv = Driver(eng, traffic(spec, dims, w, seed, rate),
                 [name for name, _, _ in w["adapters"]], State.DONE)
    rec_tr = Recorder(eng, dims, PROFILE_STEPS) if trace else None
    if rec_tr is not None and cuda:
        drv.before_step = rec_tr.before_step
    log(f"[{workload}] seed {seed}: engine built at "
        f"{time.perf_counter() - t_start:.1f} s; ramp {spec.ramp_s} s at "
        f"{rate} arrivals/s")

    # ---- ramp, then the window ------------------------------------------
    drv.run(time.perf_counter() + spec.ramp_s)
    t_open = time.perf_counter()
    setup_s = t_open - t_start
    t_close = t_open + seconds
    drv.window = (t_open, t_close)
    runner = eng.runner
    asm0 = eng.t_assembly + runner.t_assembly
    steps0 = runner.call_counts["mixed_step"]
    ev0 = len(eng.tracer.events)
    if rec_tr is not None and cuda:
        rec_tr.schedule_profile(t_open + PROFILE_AT * seconds)
    queue = [len(eng.waiting)]
    drv.run(t_close)
    queue.append(len(eng.waiting))
    asm1 = eng.t_assembly + runner.t_assembly
    steps1 = runner.call_counts["mixed_step"]
    tracer_events = eng.tracer.events[ev0:]
    if rec_tr is not None:
        rec_tr.finish()
    # ---- drain -------------------------------------------------------------
    drv.run(t_close + spec.drain_cap_s,
            stop=lambda: not drv.window_pending())
    t_drained = time.perf_counter()
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    win = drv.window_requests()
    attempted = len(win)
    failed = sum(1 for t in win if t.t_done is None)
    log(f"[{workload}] window {seconds} s: {attempted} requests due, "
        f"{failed} unfinished after a drain of {t_drained - t_close:.1f} s; "
        f"waiting queue {queue[0]} -> {queue[1]}; {drv.steps} steps")

    rec = Record(window=(t_open, t_close), setup_s=setup_s,
                 requests=drv.all_requests(), window_requests=win,
                 tracer_events=tracer_events, assembly_s=asm1 - asm0,
                 mixed_steps=steps1 - steps0, dims=dims, family=spec.family,
                 adapter_rank=spec.config["adapters"]["rank"],
                 calls=rec_tr.calls if rec_tr else [],
                 profile=rec_tr.profile if rec_tr else None)
    metrics: Dict[str, Any] = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = finite_or_none(S.metric_reader(spec, m["name"])(rec))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info: Dict[str, Any] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace and rec.profile:
        p = rec.profile
        device_info["busy_s"] = profile_read.busy_s(p)
        device_info["window_s"] = p["t1"] - p["t0"]
        breakdown = {"device_ops": profile_read.top_ops(p),
                     "idle_gaps": profile_read.idle_gaps(p, rec_tr.spans)}
    if cuda:
        device_info["power_limit"] = power_limit()
        device_info["peaks"] = {"bf16_flop_s": 989e12,
                                "hbm_bytes_s": 3.35e12}

    samples = {
        "ttft_ms": [(t.t_first - t.due) * 1e3 if t.t_first is not None
                    else None for t in win],
        "kind": [t.kind for t in win],
        "itl_ms": [round((b - a) * 1e3, 3) for t in win
                   for a, b in zip(t.tok_times, t.tok_times[1:])],
        "queue": queue, "steps": drv.steps,
        "drain_s": t_drained - t_close}

    # ---- correctness: free the program's state, then the reference ------
    picked = correctness.sample(win, seed, SAMPLE_TOKENS, SAMPLE_REQUESTS)
    keep = [_Kept(t) for t in picked]
    del drv, eng, runner, rec, rec_tr, win, picked
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    invocations = [ids for _, ids, _ in w["adapters"]]
    t_ref = time.perf_counter()
    readings = correctness.judge(spec.family, dims, w["params"], w["layers"],
                                 invocations, keep, dev, control=control) \
        if keep else {"tokens": 0}
    log(f"[{workload}] reference over {readings.get('requests', 0)} requests,"
        f" {readings.get('tokens', 0)} served tokens in "
        f"{time.perf_counter() - t_ref:.1f} s")
    limits = {k: v for k, v in spec.cell["limits"].items()
              if k in readings}
    checks = correctness.verdict(readings, limits)
    if checks is not None:
        # a request due in the window that never finished, a minute past
        # the close, never came
        checks["unfinished_requests"] = {"value": failed, "limit": 0}
    correct = checks is not None and all(
        c["value"] <= c["limit"] for c in checks.values())
    result: Dict[str, Any] = {"correct": bool(correct),
                              "attempted": attempted, "failed": failed,
                              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["readings"] = readings
    result["checks"] = checks or {"served_tokens": {"value": 0,
                                                    "limit": 1}}
    return result, samples


class _Kept:
    """A request's prompt, served tokens and adapter, kept past the
    engine for the reference."""

    def __init__(self, t):
        self.turn = t.turn
        self.rid = t.rid
        self._out = t.outputs()
        self.t_done = t.t_done
        self.prompt_len = t.prompt_len
        self.reused = t.req.n_cache_hit_tokens
        self.restored = bool(t.req.state_reused)

    def outputs(self) -> List[int]:
        return self._out


def report(result: Dict[str, Any]) -> None:
    """The checks as the last lines of standard error, then the result
    as the last line of standard output."""
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)


def sweep(workload: str, seed: int, rates: List[float], seconds: float,
          ramp_s: float, *, device: str = "cuda", root: Path = S.ROOT,
          overrides: Optional[Dict] = None, reduced: bool = False
          ) -> List[Dict[str, Any]]:
    """The rate sweep that places a cell: at each rate a fresh engine on
    the same weights, a ramp, then ``seconds`` of traffic, sampling
    before every step the waiting queue and the prompt tokens still to
    prefill (waiting prompts and the unfinished prompts of admitted
    requests: the engine admits up to ``max_running`` requests whatever
    its prefill rate, so a backlog can grow inside the running set while
    the waiting queue stays flat).  A rate the system sustains leaves
    both flat across the window."""
    import numpy as np

    from repro_torch.serving.request import State

    from alora_bench.stats import percentile
    spec, cfg, dims, w = prepare(workload, seed, device, root, overrides,
                                 reduced)
    dev = torch.device(device)
    out = []
    for rate in rates:
        eng = build_engine(spec, cfg, w, False, dev)
        drv = Driver(eng, traffic(spec, dims, w, seed, rate),
                     [name for name, _, _ in w["adapters"]], State.DONE)
        drv.run(time.perf_counter() + ramp_s)
        t_open = time.perf_counter()
        drv.window = (t_open, t_open + seconds)
        samples: List = []
        def backlog(now, eng=eng):
            todo = sum(len(r.prompt) for r in eng.waiting) + sum(
                len(r.prompt) - r.n_computed for r in eng.running
                if r.n_computed < len(r.prompt))
            samples.append((now - t_open, len(eng.waiting), len(eng.running),
                            todo))
        drv.before_step = backlog
        drv.run(t_open + seconds)
        t, q, r, b = (np.array(x, dtype=float) for x in zip(*samples)) \
            if samples else (np.zeros(2),) * 4
        win = drv.window_requests()
        ttft = [(x.t_first - x.due) * 1e3 for x in win
                if x.t_first is not None]
        ev = [x for x in win if x.kind == "eval" and x.t_done is not None]
        toks = sum(1 for x in drv.all_requests() for s in x.tok_times
                   if t_open <= s <= t_open + seconds)
        row = {"rate": rate, "steps": len(samples),
               "step_s": seconds / max(len(samples), 1),
               "waiting_first": float(q[0]), "waiting_last": float(q[-1]),
               "waiting_max": float(q.max()),
               "waiting_slope_per_s": float(np.polyfit(t, q, 1)[0])
               if len(samples) > 2 else 0.0,
               "running_mean": float(r.mean()),
               "backlog_first": float(b[0]), "backlog_last": float(b[-1]),
               "backlog_mean": float(b.mean()),
               "backlog_slope_per_s": float(np.polyfit(t, b, 1)[0])
               if len(samples) > 2 else 0.0, "due": len(win),
               "first_token": len(ttft), "output_tok_s": toks / seconds,
               "ttft_p50_ms": percentile(ttft, 50) if ttft else None,
               "ttft_p90_ms": percentile(ttft, 90) if ttft else None,
               "eval_ttft_p90_ms": percentile(
                   [(x.t_first - x.due) * 1e3 for x in ev], 90)
               if ev else None,
               "eval_reuse_pct": 100.0 * sum(x.req.n_cache_hit_tokens
                                             for x in ev)
               / max(sum(x.prompt_len for x in ev), 1)}
        log(json.dumps(row))
        out.append(row)
        del drv, eng, samples, backlog
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out
