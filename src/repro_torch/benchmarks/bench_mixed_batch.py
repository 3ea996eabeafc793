"""Mixed-batch vs sequential execution — the unified-step architecture;
the reference's ``benchmarks/bench_mixed_batch.py`` on the port.

The sequential mode dispatches one call per prefill chunk plus one per
decode batch; the mixed path packs every scheduled token (decode
singletons + prefill chunks) into ONE step — for every architecture
family (attention, SSM/hybrid via the ragged SSD scan, encoder-decoder).
This section measures exactly that: calls per step and step latency for
the same workload under both execution modes, with a warm-up round
first.  Where the reference counts device calls, the port counts
``runner.call_counts["mixed_step"]`` (one per work step, asserted for
every family, whisper's encoder calls aside) and, on the card, the
serving kernels' launches per step (B1 and B2's fused entry once per
attention layer, B2's one-pair entry and B3 once per SSM layer;
asserted).  The reference's zero-recompile asserts wait for the captured
step (ROADMAP A8).

``--mesh data=D,model=N`` adds a tensor-parallel leg: the same mixed
workload on D × N ranks (``EngineConfig.mesh``), asserting token
identity with the single-device mixed run (float32; printed as an
agreement count in bf16), one mixed step per work step and, on the
card, each rank's serving-kernel launches per step; it appends one
record to ``results/torch/sharded_step.jsonl``.  ``--data-shard`` (with
D > 1) splits the packed token axis over the data ranks
(``data_shard_tokens``); without it the leg pins it off, as the
reference's does.  Run as a module, the leg starts its ranks itself
(``distributed.spawn``; on one card they share it over gloo); under
``torchrun --nproc-per-node D*N`` every rank runs the bench and joins
torchrun's process group instead, and rank 0 reports.

Host-side batch assembly goes through the runner's persistent,
capacity-doubling, pinned staging buffers (``HostBufferPool``); the
``assembly_us_per_step`` metric isolates that host cost.

``--async`` adds an async-submission leg (``EngineConfig.
async_submission``, the schedule → submit → retire pipeline): the same
workload with one-step-lookahead submission, asserting token identity
with the synchronous mixed oracle (reduced float32 models; printed as an
agreement count in bf16), one mixed step per work step, every non-first
work step assembled while the previous step was still in flight, and a
device→host payload of SAMPLED int32 IDS ONLY (checked against the
runner's ``d2h_fetches`` log).

``--trace-check`` adds a tracing-overhead leg: the SAME mixed workload
on two engines, the tracer force-disabled on one and force-enabled on
the other, stepping in lockstep and in turns (off, on, on, off, ...);
the median over steps of the traced step's wall time over its untraced
twin's within the 2% overhead budget, asserted at ``--smoke`` on the
card and printed otherwise.  The enabled run's rings
are exported to ``results/torch/trace_mixed.perfetto.json`` and the
overhead record appends to ``results/torch/trace_overhead.jsonl``.

Every measured mode also appends one observability record (the runner's
``log_d2h`` ring summarized per tag, plus the cache-reuse ledger rolled
up per adapter) to ``results/torch/obs.jsonl``.

``--arch`` selects any registered architecture (default: the paper's
granite base model); ``--smoke`` shrinks the workload (the reference's
CI runs ``--arch mamba2-2.7b --smoke``, ``--smoke --async`` and
``--smoke --trace-check``).
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

from repro_torch.benchmarks.common import (ARCH, INV, Rows, adapter_weights,
                                           agreement, bench_args, exact,
                                           fmt_launches, launch_counts,
                                           make_engine, model, results_path,
                                           step_launches)
from repro_torch.common import resolve_device, tree_map
from repro_torch.obs import d2h_summary, reuse_by_adapter, write_perfetto
from repro_torch.serving import EngineConfig

CONCURRENCY = 6
PROMPT_LEN = 72
GEN_LEN = 16


def _submit_workload(eng, seed: int, concurrency: int, prompt_len: int,
                     gen_len: int):
    """Submit the mixed workload's requests; returns their ids."""
    cfg = eng.cfg
    rng = np.random.RandomState(seed)
    # staggered arrivals keep prefills and decodes overlapping, so most
    # steps genuinely mix both phases
    rids = []
    for i in range(concurrency):
        prompt = list(rng.randint(10, min(400, cfg.vocab_size),
                                  prompt_len + 8 * (i % 3)))
        kw = {}
        if cfg.is_encoder_decoder:
            kw = dict(frame_embeds=rng.randn(
                cfg.encoder_seq_len, cfg.d_model).astype(np.float32),
                salt=(seed, i))
        rids.append(eng.submit(prompt, gen_len,
                               adapter_name="ad0" if i % 2 else None,
                               arrival_time=1e-9 * i, **kw))
    return rids


def _workload(eng, seed: int, concurrency: int, prompt_len: int,
              gen_len: int):
    rids = _submit_workload(eng, seed, concurrency, prompt_len, gen_len)
    steps, mixed_steps, step_times = 0, 0, []
    while eng.pending or eng.waiting or eng.running:
        dt = eng.step()
        n_d, n_p = eng.last_step_tokens
        if n_d or n_p:
            steps += 1
            step_times.append(dt)
            if n_d and n_p:
                mixed_steps += 1
    return rids, steps, mixed_steps, step_times


def parse_mesh(s: str) -> dict:
    """'model=4' | 'data=2,model=4' -> ``{"data": D, "model": N}``."""
    kw = {"data": 1, "model": 1}
    for part in s.split(","):
        k, v = part.split("=")
        if k.strip() not in kw:
            raise ValueError(f"unknown mesh axis {k!r} (data/model)")
        kw[k.strip()] = int(v)
    return kw


def sharded_leg(rank, cfg, params, adapter_weights, data_shard: bool,
                concurrency: int, prompt_len: int, gen_len: int):
    """One rank of the ``--mesh`` leg: the mixed workload (warm-up, then
    measured) on an engine over ``rank.mesh``, from ``params`` and the
    rank-32 aLoRA ``adapter_weights``.  Returns the measured run's
    tokens, work steps, mixed-step calls, step times, assembly time and
    serving-kernel launches per step."""
    from repro_torch.core.alora import PAPER_ALORA_RANK, AdapterSpec
    from repro_torch.serving import Engine
    spec = AdapterSpec("ad0", rank=PAPER_ALORA_RANK, invocation_tokens=INV)
    for seed in (999, 7):                           # warmup + measured
        eng = Engine(cfg, params, adapters=[(spec, adapter_weights)],
                     device=rank.device, engine_cfg=EngineConfig(
                         max_running=8, max_batched_tokens=128,
                         mesh=rank.mesh, data_shard_tokens=data_shard))
        before = launch_counts()
        rids, steps, _, times = _workload(eng, seed, concurrency,
                                          prompt_len, gen_len)
    return dict(tokens=[list(map(int, eng.request(r).output_tokens))
                        for r in rids],
                steps=steps, calls=eng.runner.call_counts["mixed_step"],
                times=times, t_asm=eng.t_assembly + eng.runner.t_assembly,
                launches=step_launches(eng, steps, before),
                exact=exact(eng))


def run_sharded_leg(arch: str, mesh: dict, data_shard: bool, device,
                    concurrency: int, prompt_len: int, gen_len: int):
    """Every rank's :func:`sharded_leg` result: this process's rank alone
    under torchrun, else the ranks :func:`distributed.spawn.launch`
    starts (the model's weights and adapter handed over on the CPU)."""
    from repro_torch.core.alora import PAPER_ALORA_RANK
    from repro_torch.distributed import spawn
    cfg, params = model(arch, device)
    ad = adapter_weights(arch, PAPER_ALORA_RANK, 0, device)
    args = (data_shard, concurrency, prompt_len, gen_len)
    if "WORLD_SIZE" in os.environ:
        rank = spawn.from_env(mesh["data"], mesh["model"], device)
        return [sharded_leg(rank, cfg, params, ad, *args)]
    cpu = lambda t: t.cpu()  # noqa: E731
    return spawn.launch(sharded_leg, cfg, tree_map(cpu, params),
                        tree_map(cpu, ad), *args, data=mesh["data"],
                        model=mesh["model"], device=device.type)


TRACE_OVERHEAD_BUDGET = 0.02      # the tracer's promised overhead
# rounds of the workload after the warm-up round, at --smoke on the card:
# the host's speed drifts by tens of percent between runs a fraction of
# a second apart, so the two settings step in lockstep and each step is
# compared with its twin
TRACE_CHECK_ROUNDS = 20


def trace_overhead_check(arch: str, smoke: bool, concurrency: int,
                         prompt_len: int, gen_len: int, device,
                         rows: Rows) -> None:
    """The tracing-overhead leg: two engines on the same weights, the
    tracer off on one and on on the other, serve the same mixed workload
    in lockstep, stepping in turns (off, on, on, off, ...), so that both
    settings of each step run a few milliseconds apart.  The overhead is
    the median over steps of the traced step's host wall time over its
    untraced twin's, minus one.  After a warm-up round,
    ``TRACE_CHECK_ROUNDS`` rounds at ``--smoke`` on the card, which must
    stay within the 2% budget; one round elsewhere, printed."""
    check = smoke and device.type == "cuda"
    engs = {flag: make_engine("alora", arch=arch, device=device,
                              ecfg=EngineConfig(max_running=8,
                                                max_batched_tokens=128,
                                                trace=flag))
            for flag in (False, True)}
    rounds = TRACE_CHECK_ROUNDS if check else 1
    times = {False: [], True: []}
    # the order flips every step and carries over between rounds, so
    # each setting steps first in half the pairs
    order = [False, True]
    for r in range(rounds + 1):                   # round 0 warms up
        walls = {False: [], True: []}
        for eng in engs.values():
            _submit_workload(eng, 999 if r == 0 else 6 + r, concurrency,
                             prompt_len, gen_len)
        while not all(eng.idle for eng in engs.values()):
            for flag in order:
                eng = engs[flag]
                t0 = time.perf_counter()
                eng.step()
                walls[flag].append(time.perf_counter() - t0)
            order.reverse()
        # the same schedule on both: step k of one is step k of the other
        assert len(walls[False]) == len(walls[True])
        if r:
            for flag in walls:
                times[flag] += walls[flag]
    off, on = (np.array(times[f]) for f in (False, True))
    overhead = float(np.median(on / off)) - 1
    off_us, on_us = float(np.median(off)) * 1e6, float(np.median(on)) * 1e6
    traced = engs[True]
    if check:
        assert overhead < TRACE_OVERHEAD_BUDGET, \
            f"tracing overhead {overhead:.1%} exceeds the " \
            f"{TRACE_OVERHEAD_BUDGET:.0%} budget"
    rows.add(f"mixed_batch/{arch}/trace_overhead", overhead * 100,
             f"traced={on_us:.0f}us untraced={off_us:.0f}us (% median of "
             f"the {len(on)} steps' traced/untraced wall time, {rounds} "
             f"round(s) in lockstep"
             f"{'' if check else '; budget not asserted'})",
             overhead=overhead, events=len(traced.tracer.events))
    write_perfetto(results_path("trace_mixed.perfetto.json"),
                   [traced.tracer])
    with open(results_path("trace_overhead.jsonl"), "a") as f:
        f.write(json.dumps(dict(
            arch=arch, smoke=smoke, traced_us=on_us, untraced_us=off_us,
            overhead_pct=overhead * 100, rounds=rounds, steps=len(on),
            events=len(traced.tracer.events))) + "\n")


def run(arch: str = ARCH, smoke: bool = False, async_leg: bool = False,
        trace_check: bool = False, device="cuda", mesh: dict = None,
        data_shard: bool = False) -> Rows:
    device = resolve_device(device)
    if data_shard and (mesh is None or mesh.get("data", 1) < 2):
        raise SystemExit("--data-shard needs --mesh data=D,... with D>1")
    concurrency = 3 if smoke else CONCURRENCY
    prompt_len = 24 if smoke else PROMPT_LEN
    gen_len = 8 if smoke else GEN_LEN
    # "mixed" is pinned to the SYNCHRONOUS oracle (async_submission off)
    # so the async leg has a baseline to be token-checked against;
    # "mixed_async" (--async) runs the one-step-lookahead pipeline
    modes = ["sequential", "mixed"] + (["mixed_async"] if async_leg else [])
    rows = Rows()
    baseline_us = None            # synchronous mixed mean step latency
    mixed_tokens = None
    for mode in modes:
        ecfg_kw = dict(max_running=8, max_batched_tokens=128)
        if mode != "mixed_async":       # mixed_async: the defaults
            ecfg_kw["execution_mode"] = mode
            ecfg_kw["async_submission"] = False
        for seed in (999, 7):                     # warmup + measured
            eng = make_engine("alora", arch=arch, device=device,
                              ecfg=EngineConfig(**ecfg_kw))
            before = launch_counts()
            rids, steps, mixed_steps, times = _workload(
                eng, seed, concurrency, prompt_len, gen_len)
        counts = dict(eng.runner.call_counts)
        calls = counts["mixed_step"] if mode != "sequential" \
            else counts["prefill_chunk"] + counts["decode_batch"]
        out = [eng.request(r).output_tokens for r in rids]
        assert sum(len(t) for t in out) == gen_len * len(rids)
        data = dict(tokens=out, steps=steps, calls=calls,
                    hits=[eng.request(r).n_cache_hit_tokens for r in rids])
        launches = ""
        if mode == "mixed":
            mixed_tokens = out
            baseline_us = float(np.mean(times)) * 1e6
        if mode != "sequential":
            # the unified-step invariant: one mixed step per work step,
            # and on the card the serving kernels' launches per step
            assert calls == steps, (calls, steps)
            data["launches"] = per_step = step_launches(eng, steps, before)
            launches = f" launches/step: {fmt_launches(per_step)}"
        rows.add(f"mixed_batch/{arch}/{mode}/step_latency",
                 float(np.mean(times)) * 1e6,
                 f"p50={np.median(times)*1e6:.0f}us "
                 f"p99={np.percentile(times, 99)*1e6:.0f}us", **data)
        rows.add(f"mixed_batch/{arch}/{mode}/device_calls_per_step",
                 calls / max(steps, 1),
                 f"calls={calls} steps={steps} both_phase_steps="
                 f"{mixed_steps} counts={counts}{launches}")
        # observability record: the runner's D2H ring per tag + the
        # cache-reuse ledger per adapter
        with open(results_path("obs.jsonl"), "a") as f:
            f.write(json.dumps(dict(
                arch=arch, smoke=smoke, mode=mode, steps=steps,
                d2h=d2h_summary(eng.runner.d2h_fetches),
                reuse=reuse_by_adapter([eng.tracer]))) + "\n")
        if mode != "sequential":
            # engine-side packing + runner-side bucket padding/staging
            t_asm = eng.t_assembly + eng.runner.t_assembly
            rows.add(f"mixed_batch/{arch}/{mode}/assembly_us_per_step",
                     t_asm / max(steps, 1) * 1e6,
                     "host batch-pack time (persistent pinned buffers)")
        if mode == "mixed_async":
            # async invariants: token identity with the synchronous
            # mixed oracle; every work step after the first assembled
            # while the previous step was still in flight; the D2H
            # payload is sampled int32 ids only — never (R, vocab)
            # logits (no full-logits transfer on the decode path)
            if exact(eng):
                assert out == mixed_tokens, \
                    "async submission diverged from the sync mixed oracle"
            overlap = eng.async_overlap_steps
            assert overlap >= steps - 2, (overlap, steps)
            fetches = [(e, d) for e, d, tag in eng.runner.d2h_fetches
                       if tag == "step"]
            assert fetches and all(d == "int32" for _, d in fetches), \
                [d for _, d in fetches[:4]]
            max_elems = max(e for e, _ in fetches)
            assert max_elems < eng.cfg.vocab_size, \
                f"per-step D2H of {max_elems} elems looks like logits"
            async_us = float(np.mean(times)) * 1e6
            rows.add(f"mixed_batch/{arch}/{mode}/vs_sync_submission",
                     async_us / baseline_us,
                     f"async={async_us:.0f}us sync={baseline_us:.0f}us "
                     f"overlapped={overlap}/{steps} steps "
                     f"d2h_max={max_elems} int32 elems/step (ids, not "
                     f"logits); vs sync: {agreement(out, mixed_tokens)}",
                     overlap=overlap, d2h_max=max_elems)
    if mesh is not None:
        sharded_check(arch, smoke, mesh, data_shard, device, concurrency,
                      prompt_len, gen_len, mixed_tokens, baseline_us, rows)
    if trace_check:
        trace_overhead_check(arch, smoke, concurrency, prompt_len, gen_len,
                             device, rows)
    return rows


def sharded_check(arch, smoke, mesh, data_shard, device, concurrency,
                  prompt_len, gen_len, mixed_tokens, baseline_us,
                  rows: Rows) -> None:
    """The ``--mesh`` leg against the single-device mixed run: every rank
    holds the same tokens, equal to the mixed run's (float32), and makes
    one mixed-step call per work step."""
    res = run_sharded_leg(arch, mesh, data_shard, device, concurrency,
                          prompt_len, gen_len)
    r0 = res[0]
    for r in res[1:]:
        assert r["tokens"] == r0["tokens"], "ranks disagree on the tokens"
    out, steps, times = r0["tokens"], r0["steps"], r0["times"]
    assert r0["calls"] == steps, (r0["calls"], steps)
    if r0["exact"]:
        assert out == mixed_tokens, \
            "sharded mixed step diverged from single-device tokens"
    tag = f"mixed@{mesh['data']}x{mesh['model']}" \
        + ("+ds" if data_shard else "")
    us = float(np.mean(times)) * 1e6
    rows.add(f"mixed_batch/{arch}/{tag}/step_latency", us,
             f"p50={np.median(times)*1e6:.0f}us "
             f"p99={np.percentile(times, 99)*1e6:.0f}us",
             tokens=out, steps=steps, calls=r0["calls"],
             launches=r0["launches"])
    rows.add(f"mixed_batch/{arch}/{tag}/vs_single_device", us / baseline_us,
             f"sharded={us:.0f}us single={baseline_us:.0f}us "
             f"launches/step per rank: {fmt_launches(r0['launches'])}; vs "
             f"single: {agreement(out, mixed_tokens)}")
    with open(results_path("sharded_step.jsonl"), "a") as f:
        f.write(json.dumps(dict(
            arch=arch, smoke=smoke, device=device.type,
            mesh=f"{mesh['data']}x{mesh['model']}", data_shard=data_shard,
            step_latency_us=us, baseline_us=baseline_us,
            assembly_us_per_step=r0["t_asm"] / max(steps, 1) * 1e6,
            device_calls_per_step=r0["calls"] / max(steps, 1),
            launches_per_step=r0["launches"], steps=steps,
            token_agreement=agreement(out, mixed_tokens))) + "\n")


if __name__ == "__main__":
    a = bench_args(__doc__.splitlines()[0], **{
        "--async": dict(dest="async_leg", action="store_true",
                        help="add an async-submission leg (one-step "
                             "lookahead) checked against the synchronous "
                             "mixed oracle, asserting the sampled-ids-only "
                             "D2H payload"),
        "--trace-check": dict(dest="trace_check", action="store_true",
                              help="add a tracing-overhead leg: tracer on "
                                   "vs off on the same mixed workload"),
        "--mesh": dict(default=None,
                       help="add a tensor-parallel leg over D x N ranks: "
                            "'model=N' or 'data=D,model=N'"),
        "--data-shard": dict(dest="data_shard", action="store_true",
                             help="split the packed token axis over the "
                                  "data ranks in the --mesh leg")})
    if int(os.environ.get("RANK", "0")):
        # under torchrun rank 0 reports; the others keep their rows and
        # records to themselves
        import sys
        import tempfile
        from repro_torch.benchmarks import common
        sys.stdout = open(os.devnull, "w")
        common.RESULTS = tempfile.mkdtemp(prefix="repro_torch_rank_")
    run(a.arch, a.smoke, async_leg=a.async_leg, trace_check=a.trace_check,
        device=a.device, mesh=parse_mesh(a.mesh) if a.mesh else None,
        data_shard=a.data_shard)
