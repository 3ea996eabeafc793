#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. card and setup: the card's name and power limit, the torch/CUDA
   versions, TF32 off, and the build of the CUDA kernels from
   ``src/repro_torch/csrc`` (timed);
2. every kernel against its plain PyTorch version on the same card
   tensors, at the main path's shapes, in bfloat16 and float32, with
   times (CUDA events, L2 flushed before each launch), the least time
   the card could take for the same work, and the time of one library
   call computing the same function where there is one;
3. the main path at full width: granite-3.2-8b (random weights from a
   seed) serving the paper's base → aLoRA pipeline through the mixed
   step, with the launch counts of both kernels read just after;
4. parity of the kernel path: the reduced float32 granite with two
   adapters cycling through one device slot, the same weights and the
   same pipeline on the card and on the CPU — identical tokens,
   prefix-cache hits and adapter evictions.

The line before the last is the ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``.  The script imports nothing
of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, per type
# max |err| / max |plain|, taken per output row for attention (whose rows
# differ in scale by the context length) and over the whole output for
# the LoRA delta (whose rows share one scale)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
WINDOW = 24                     # sliding-window case of the attention check
INV = (7, 8, 9)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode:
        fail(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median time of one call, by CUDA events, with the 50 MB L2 cache
    flushed before each launch (the main path's callers find it cold:
    every layer reads other weights between two calls)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, n: int = 25, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(n):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def rel_err(got, want, rows=None):
    """Over ``rows``: (max |got - want|, that over max |want|, the largest
    per-row max |got - want| over that row's max |want|)."""
    g, w = got.float(), want.float()
    if rows is not None:
        g, w = g[rows], w[rows]
    if not bool(g.isfinite().all()):
        fail("kernel output holds non-finite values")
    d = (g - w).abs().reshape(g.shape[0], -1).amax(1)
    scale = w.abs().reshape(w.shape[0], -1).amax(1).clamp_min(1e-30)
    err = d.max().item()
    return err, err / scale.max().item(), (d / scale).max().item()


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def attention_inputs(torch, cfg, dtype, gen):
    """A main-path mixed batch: 8 decode rows with contexts up to 600,
    a 64-token prefill chunk at positions 256..319 and a 48-token first
    chunk, padded to the pow2 bucket T = 128 with q_lens == 0 rows."""
    bs, NB = 16, 513
    KV, hd, H = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    dump = NB - 1
    contexts = [37, 120, 200, 255, 300, 411, 530, 600, 320, 48]
    tables, rows, lens = [], [], []
    perm = torch.randperm(NB - 1, generator=gen).tolist()
    nxt = 0
    for r, ctx in enumerate(contexts):
        nblk = (ctx + bs - 1) // bs
        tables.append(perm[nxt:nxt + nblk])
        nxt += nblk
    for r in range(8):                                  # decode rows
        rows.append(r)
        lens.append(contexts[r])
    for r, lo, hi in ((8, 256, 320), (9, 0, 48)):       # prefill chunks
        rows += [r] * (hi - lo)
        lens += list(range(lo + 1, hi + 1))
    R, Tb = 16, 128
    n_real = len(rows)
    rows += [R - 1] * (Tb - n_real)                     # padded rows
    lens += [0] * (Tb - n_real)
    nbb = 64
    bt = torch.full((R, nbb), dump, dtype=torch.int32)
    for r, t in enumerate(tables):
        bt[r, :len(t)] = torch.tensor(t, dtype=torch.int32)
    dev = "cuda"
    q = torch.randn((Tb, H, hd), generator=gen).to(dev, dtype)
    kp = torch.randn((NB, bs, KV, hd), generator=gen).to(dev, dtype)
    vp = torch.randn((NB, bs, KV, hd), generator=gen).to(dev, dtype)
    return dict(q=q, k_pool=kp, v_pool=vp, block_tables=bt.to(dev),
                req_rows=torch.tensor(rows, dtype=torch.int32, device=dev),
                q_lens=torch.tensor(lens, dtype=torch.int32, device=dev),
                n_real=n_real, tables=tables, lens=lens, rows=rows)


def check_attention(torch, cfg, timer, gen):
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import (
        ragged_paged_attention, ragged_paged_attention_ref)
    res = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        a = attention_inputs(torch, cfg, dtype, gen)
        args = (a["q"], a["k_pool"], a["v_pool"], a["block_tables"],
                a["req_rows"], a["q_lens"])
        got = ragged_paged_attention(*args)
        want = ragged_paged_attention_ref(*args)
        torch.cuda.synchronize()
        n = a["n_real"]
        err, rel, row_rel = rel_err(got, want, slice(0, n))
        if row_rel > TOL[dtype_name]:
            fail(f"ragged_paged_attention {dtype_name}: max|err| {err}, "
                 f"{row_rel} of a row's max|plain| > {TOL[dtype_name]}")
        if dtype_name == "float32":
            # the sliding-window branch of the kernel's loop
            got_w = ragged_paged_attention(*args, window=WINDOW)
            want_w = ragged_paged_attention_ref(*args, window=WINDOW)
            torch.cuda.synchronize()
            err_w, _, row_rel_w = rel_err(got_w, want_w, slice(0, n))
            if row_rel_w > TOL[dtype_name]:
                fail(f"ragged_paged_attention float32 window={WINDOW}: "
                     f"max|err| {err_w}, {row_rel_w} of a row's max|plain| "
                     f"> {TOL[dtype_name]}")
            print(f"  ragged_paged_attention float32 window={WINDOW}: "
                  f"max|err| {err_w:.3e} (row rel {row_rel_w:.3e})",
                  flush=True)
        if bool(got[n:].float().abs().max() != 0):
            fail("ragged_paged_attention: q_lens == 0 rows are not zero")
        # the kernel never reads past q_len: NaN in the dump block
        # (padding entries of every table) must not reach any row
        a["k_pool"][-1] = float("nan")
        a["v_pool"][-1] = float("nan")
        again = ragged_paged_attention(*args)
        torch.cuda.synchronize()
        if not torch.equal(again, got):
            fail("ragged_paged_attention reads past q_len (dump block)")
        a["k_pool"][-1] = 0.0
        a["v_pool"][-1] = 0.0
        entry = {"max_abs_err": err, "rel_err": rel, "row_rel_err": row_rel,
                 "tol": TOL[dtype_name]}
        if dtype_name == "float32":
            entry.update(window=WINDOW, max_abs_err_window=err_w,
                         row_rel_err_window=row_rel_w)
        if dtype_name == "bfloat16":
            entry.update(time_attention(torch, F, timer, a, args, dtype_name,
                                        ragged_paged_attention,
                                        ragged_paged_attention_ref))
            # a pure-decode step of 8 running requests: T = 8, so only
            # T x KV = 64 thread blocks for 132 SMs
            d8 = dict(a, q=a["q"][:8].contiguous(),
                      req_rows=a["req_rows"][:8].contiguous(),
                      q_lens=a["q_lens"][:8].contiguous(), n_real=8,
                      lens=a["lens"][:8], rows=a["rows"][:8])
            args8 = (d8["q"], d8["k_pool"], d8["v_pool"], d8["block_tables"],
                     d8["req_rows"], d8["q_lens"])
            entry["decode8"] = time_attention(
                torch, F, timer, d8, args8, dtype_name,
                ragged_paged_attention, ragged_paged_attention_ref)
        res[dtype_name] = entry
        print(f"  ragged_paged_attention {dtype_name}: max|err| {err:.3e} "
              f"(row rel {row_rel:.3e}, tol {TOL[dtype_name]}; rel to the "
              f"batch's max {rel:.3e})", flush=True)
    return res


def time_attention(torch, F, timer, a, args, dtype_name, kernel, plain):
    q = a["q"]
    T, H, hd = q.shape
    _, bs, KV, _ = a["k_pool"].shape
    es = q.element_size()
    n = a["n_real"]
    lens, rows, tables = a["lens"], a["rows"], a["tables"]
    blocks = set()
    ops = 0
    for t in range(n):
        blocks.update(tables[rows[t]][:(lens[t] + bs - 1) // bs])
        ops += 4 * H * hd * lens[t]                  # QK^T and PV
    nbytes = 2 * T * H * hd * es + 2 * len(blocks) * bs * KV * hd * es \
        + 4 * (a["block_tables"].numel() + 2 * T)
    bound_ms, bound_by = bound(nbytes, ops, dtype_name)
    ms = timer(lambda: kernel(*args))
    plain_ms = timer(lambda: plain(*args))
    # library yardstick: scaled_dot_product_attention over K/V gathered
    # per token beforehand, with the same mask (timed here only)
    nbb = a["block_tables"].shape[1]
    bt = a["block_tables"].long()[a["req_rows"].long()]
    k = a["k_pool"][bt].reshape(T, nbb * bs, KV, hd).transpose(1, 2)
    v = a["v_pool"][bt].reshape(T, nbb * bs, KV, hd).transpose(1, 2)
    k, v = k.contiguous(), v.contiguous()
    pos = torch.arange(nbb * bs, device="cuda")
    mask = (pos[None, :] < a["q_lens"][:, None])[:, None, None, :]
    qq = q[:, :, None, :]
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask, enable_gqa=True))
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "ops": ops}


def check_lora(torch, cfg, timer, gen):
    from repro_torch.kernels.ragged_lora import (ragged_grouped_lora,
                                                 ragged_grouped_lora_ref)
    T, d, r, S = 128, cfg.d_model, 32, 3
    active = [1, 2]                 # 3 resident slots, 2 active
    idx = torch.tensor([0, 1, 2, 3] * (T // 4), dtype=torch.int32)
    idx = idx[torch.randperm(T, generator=gen)]
    res = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for out_dim in (cfg.num_heads * cfg.head_dim,
                        cfg.num_kv_heads * cfg.head_dim):
            x = torch.randn((T, d), generator=gen).to("cuda", dtype)
            a = (torch.randn((S + 1, d, r), generator=gen) / d ** 0.5)
            b = torch.randn((S + 1, r, out_dim), generator=gen) \
                * (0.02 / r ** 0.5)
            a[0] = 0
            b[0] = 0
            a, b = a.to("cuda", dtype), b.to("cuda", dtype)
            ii = idx.to("cuda")
            act = torch.tensor(active, dtype=torch.int32, device="cuda")
            got = ragged_grouped_lora(x, a, b, ii, act)
            want = ragged_grouped_lora_ref(x, a, b, ii, act)
            torch.cuda.synchronize()
            err, rel, row_rel = rel_err(got, want)
            if rel > TOL[dtype_name]:
                fail(f"ragged_grouped_lora {dtype_name} out={out_dim}: "
                     f"max|err| {err} = {rel} of max|plain| > "
                     f"{TOL[dtype_name]}")
            inactive = (ii == 0) | (ii == 3)
            if bool(got[inactive].float().abs().max() != 0):
                fail("ragged_grouped_lora: slot 0 or an inactive slot "
                     "leaked into the delta")
            print(f"  ragged_grouped_lora {dtype_name} out={out_dim}: "
                  f"max|err| {err:.3e} (rel {rel:.3e}, tol "
                  f"{TOL[dtype_name]}; largest row rel {row_rel:.3e})",
                  flush=True)
            key = f"{dtype_name}_out{out_dim}"
            res[key] = {"max_abs_err": err, "rel_err": rel,
                        "row_rel_err": row_rel, "tol": TOL[dtype_name]}
            if dtype_name == "bfloat16":
                es = x.element_size()
                n_on = int(((ii == 1) | (ii == 2)).sum())
                nbytes = (T * d + len(active) * (d * r + r * out_dim)
                          + T * out_dim) * es + 4 * (T + len(active))
                ops = n_on * 2 * r * (d + out_dim)
                bound_ms, bound_by = bound(nbytes, ops, dtype_name)
                res[key].update(
                    ms=timer(lambda: ragged_grouped_lora(x, a, b, ii, act)),
                    plain_ms=timer(lambda: ragged_grouped_lora_ref(
                        x, a, b, ii, act)),
                    library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                    bytes=nbytes, ops=ops)
    return res


# ---------------------------------------------------------------------------
# phases 3 and 4: the engine
# ---------------------------------------------------------------------------
def reset_counts():
    from repro_torch.kernels import paged_attention, ragged_lora
    paged_attention.ragged_paged_attention.launches = 0
    ragged_lora.ragged_grouped_lora.launches = 0


def read_counts():
    from repro_torch.kernels import paged_attention, ragged_lora
    return (paged_attention.ragged_paged_attention.launches,
            ragged_lora.ragged_grouped_lora.launches)


def run_pipeline(torch, eng, adapter_names=("eval",), **kw):
    from repro_torch.serving import pipelines
    step_ms = []
    orig = eng.step

    def timed_step():
        t0 = time.perf_counter()
        out = orig()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    eng.step = timed_step
    res = pipelines.base_adapter(eng, adapter_names=list(adapter_names),
                                 **kw)
    if eng.runner.device.type == "cuda":
        torch.cuda.synchronize()
    return res, step_ms


def main_path(torch):
    from repro_torch.configs import get_config
    from repro_torch.core.alora import AdapterSpec, init_adapter_weights
    from repro_torch.models.layers import padded_vocab
    from repro_torch.models.model import init_params
    from repro_torch.serving import Engine

    cfg = get_config("granite-3.2-8b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(gen, cfg, device="cuda")
    adapter = init_adapter_weights(gen, cfg, 32, device="cuda")
    eng = Engine(cfg, params, device="cuda",
                 adapters=[(AdapterSpec("eval", 32, INV), adapter)])
    torch.cuda.synchronize()
    print(f"  {cfg.name}: {cfg.param_count() / 1e9:.2f} B parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, "
          f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res, step_ms = run_pipeline(torch, eng, prompt_len=256, gen_len=32,
                                eval_len=8, batch=4, seed=0)
    n_attn, n_lora = read_counts()
    steps = eng.runner.call_counts["mixed_step"]
    ids = res.base_ids + res.eval_ids
    outs = [eng.request(i).output_tokens for i in ids]
    emitted = sum(len(o) for o in outs)
    hits = [eng.request(i).n_cache_hit_tokens for i in res.eval_ids]
    print(f"  mixed steps {steps}, engine steps {len(step_ms)}, step ms "
          f"mean {statistics.mean(step_ms):.3f} median "
          f"{statistics.median(step_ms):.3f}, tokens emitted {emitted}, "
          f"eval n_cache_hit_tokens {hits}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    print(f"  launches: ragged_paged_attention {n_attn}, "
          f"ragged_grouped_lora {n_lora}", flush=True)
    vpad = padded_vocab(cfg)
    for rid, o in zip(ids, outs):
        want = 32 if rid in res.base_ids else 8
        if len(o) != want or not all(0 <= t < vpad for t in o):
            fail(f"request {rid}: tokens {o} are not {want} ids < {vpad}")
    if min(hits) < 256:
        fail(f"an eval request reused fewer than 256 tokens: {hits}")
    if n_attn != cfg.num_layers * steps or n_lora != 3 * cfg.num_layers \
            * steps:
        fail(f"launch counts {n_attn}/{n_lora} != {cfg.num_layers}x/"
             f"{3 * cfg.num_layers}x {steps} mixed steps")
    if eng.kv_mgr.num_free() != eng.kv_mgr.num_blocks \
            or any(m.ref for m in eng.kv_mgr.meta):
        fail("KV blocks leaked after the drain")
    # the staging buffers the step uploads from are pinned, so the
    # non_blocking uploads really are asynchronous
    probe = eng.runner.host_bufs.take("probe", 1, np.int32)
    if not torch.from_numpy(probe).is_pinned():
        fail("host staging buffers are not pinned")
    phases = {}
    for kind, track, _, t0_, t1_, _, _ in eng.tracer.events:
        if kind == "span":
            phases.setdefault(track, []).append((t1_ - t0_) * 1e3)
    phase_ms = {k: statistics.mean(v) for k, v in phases.items()}
    print("  mean host ms per phase: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phase_ms.items()), flush=True)
    # the per-step host-embedding upload the assembly mirrors from the
    # reference: a (128, d) float32 pinned buffer, non_blocking
    host = torch.empty((128, cfg.d_model), dtype=torch.float32,
                       pin_memory=True)
    up = Timer(torch)(lambda: host.to("cuda", non_blocking=True))
    print(f"  host-embed upload (128 x {cfg.d_model} fp32): {up:.4f} ms",
          flush=True)
    summary = {"steps": steps, "step_ms_mean": statistics.mean(step_ms),
               "step_ms_median": statistics.median(step_ms),
               "tokens_emitted": emitted, "eval_cache_hits": hits,
               "launches": {"ragged_paged_attention": n_attn,
                            "ragged_grouped_lora": n_lora},
               "phase_ms": phase_ms, "host_embed_upload_ms": up}
    summary["decode_profile"] = profile_decode(torch, eng, cfg)
    del eng, params, adapter
    torch.cuda.empty_cache()
    return summary


def profile_decode(torch, eng, cfg, n_steps: int = 8):
    """Where a steady decode step's time goes: 4 running requests with
    256-token contexts, n_steps timed plainly, then n_steps under
    torch.profiler for the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(1)
    for _ in range(4):
        eng.submit(list(rng.randint(10, cfg.vocab_size, 256)),
                   3 * n_steps + 8)
    for _ in range(64):                 # admission + prefill
        eng.step()
        if eng.running and not eng.waiting and not eng.last_step_tokens[1]:
            break
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
    eng.run_until_idle()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0) or 0

    # device work = the kernel/memcpy events themselves (a CPU op's own
    # device total repeats the time of the kernels it launched)
    averages = prof.key_averages()
    kernels = [e for e in averages
               if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / n_steps
    per_step = lambda us: us / 1e3 / n_steps  # noqa: E731
    top_dev = sorted(kernels, key=dev_us, reverse=True)[:8]
    top_host = sorted((e for e in averages
                       if str(e.device_type).endswith("CPU")),
                      key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    # host cost of one eager launch: a stream of tiny in-place adds
    t = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        t.add_(1)
    launch_us = (time.perf_counter() - t0) * 1e6 / 2000
    torch.cuda.synchronize()
    out = {"step_ms": step_ms, "device_busy_ms": busy_ms or None,
           "device_idle_share": (1 - busy_ms / step_ms) if busy_ms
           else None, "host_us_per_eager_launch": launch_us,
           "top_device_ms_per_step": {e.key[:70]: per_step(dev_us(e))
                                      for e in top_dev},
           "top_host_ms_per_step_profiled": {
               e.key[:70]: (per_step(e.self_cpu_time_total), e.count
                            // n_steps) for e in top_host}}
    print(f"  decode step (4 x 256 context): {step_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms/step" if busy_ms else
          f"  decode step: {step_ms:.3f} ms, device time not measured "
          "(the profiler saw no device events)", flush=True)
    print(f"  host us per eager launch: {launch_us:.2f}", flush=True)
    for k, v in out["top_device_ms_per_step"].items():
        print(f"    device {v:8.3f} ms/step  {k}", flush=True)
    for k, (v, n) in out["top_host_ms_per_step_profiled"].items():
        print(f"    host   {v:8.3f} ms/step  {n:5d} calls/step  {k}",
              flush=True)
    return out


def parity(torch):
    from repro_torch.configs import get_reduced
    from repro_torch.core.alora import AdapterSpec, init_adapter_weights
    from repro_torch.models.model import init_params
    from repro_torch.serving import Engine, EngineConfig

    cfg = get_reduced("granite-3.2-8b")
    gen = torch.Generator().manual_seed(1)
    params = init_params(gen, cfg, device="cpu")
    # two adapters through one device slot: every switch evicts, stages
    # on the side stream and installs in place
    adapters = [(AdapterSpec("eval", 8, INV),
                 init_adapter_weights(gen, cfg, 8, device="cpu")),
                (AdapterSpec("lora", 8, None),
                 init_adapter_weights(gen, cfg, 8, device="cpu"))]
    runs = {}
    for device in ("cuda", "cpu"):
        eng = Engine(cfg, params, device=device, adapters=adapters,
                     engine_cfg=EngineConfig(adapter_slots=1))
        res, _ = run_pipeline(torch, eng, adapter_names=("eval", "lora"),
                              prompt_len=40, gen_len=12, eval_len=6,
                              batch=3, seed=3)
        runs[device] = ([eng.request(i).output_tokens
                         for i in res.base_ids + res.eval_ids],
                        eng.kv_mgr.hits, eng.adapter_pool.evictions)
    if runs["cuda"] != runs["cpu"]:
        fail(f"card and CPU disagree: {runs}")
    print(f"  reduced fp32 card == CPU: {len(runs['cpu'][0])} requests, "
          f"hits {runs['cpu'][1]}, adapter evictions {runs['cpu'][2]}",
          flush=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("[1] build", flush=True)
    t0 = time.perf_counter()
    _, log = build.build()
    build.load()
    print(f"  kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip(), flush=True)

    print("[2] kernels vs plain", flush=True)
    cfg = get_config("granite-3.2-8b")
    gen = torch.Generator().manual_seed(0)
    timer = Timer(torch)
    attn = check_attention(torch, cfg, timer, gen)
    lora = check_lora(torch, cfg, timer, gen)
    del timer
    torch.cuda.empty_cache()

    print("[3] main path, full width", flush=True)
    mp = main_path(torch)

    print("[4] parity, reduced fp32, card vs CPU", flush=True)
    parity(torch)

    steps = mp["steps"]
    a16, l16 = attn["bfloat16"], lora[f"bfloat16_out{cfg.num_heads * cfg.head_dim}"]
    kernels = [
        {"name": "ragged_paged_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:83",
         "launches": mp["launches"]["ragged_paged_attention"],
         "launches_per_step": mp["launches"]["ragged_paged_attention"]
         / steps,
         "max_abs_err": a16["max_abs_err"], "tol": a16["tol"],
         "row_rel_err": a16["row_rel_err"],
         "max_abs_err_fp32": attn["float32"]["max_abs_err"],
         "max_abs_err_fp32_window": attn["float32"]["max_abs_err_window"],
         "tol_fp32": attn["float32"]["tol"],
         "ms": a16["ms"], "kernel_ms": a16["ms"],
         "plain_ms": a16["plain_ms"], "bound_ms": a16["bound_ms"],
         "bound_by": a16["bound_by"], "library_ms": a16["library_ms"],
         "decode8": {k: a16["decode8"][k] for k in
                     ("ms", "plain_ms", "library_ms", "bound_ms",
                      "bound_by")}},
        {"name": "ragged_grouped_lora", "route": "cuda",
         "source": "src/repro_torch/csrc/ragged_lora.cu",
         "replaces": "src/repro/kernels/ragged_lora.py:82",
         "launches": mp["launches"]["ragged_grouped_lora"],
         "launches_per_step": mp["launches"]["ragged_grouped_lora"] / steps,
         "max_abs_err": l16["max_abs_err"], "tol": l16["tol"],
         "max_abs_err_fp32": max(v["max_abs_err"] for k, v in lora.items()
                                 if k.startswith("float32")),
         "tol_fp32": TOL["float32"],
         "ms": l16["ms"], "kernel_ms": l16["ms"],
         "plain_ms": l16["plain_ms"], "bound_ms": l16["bound_ms"],
         "bound_by": l16["bound_by"], "library_ms": None,
         "ms_out1024": lora["bfloat16_out1024"]["ms"],
         "bound_ms_out1024": lora["bfloat16_out1024"]["bound_ms"]},
    ]
    print(json.dumps({"main_path": mp, "card": card,
                      "seconds": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
