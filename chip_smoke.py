#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. card and setup: the card's name and power limit, the torch/CUDA
   versions, TF32 off, and the build of the CUDA kernels from
   ``src/repro_torch/csrc`` (timed);
2. every kernel against its plain PyTorch version on the same card
   tensors, at the main paths' shapes, with times (CUDA events, L2
   flushed before each launch), the least time the card could take for
   the same work, and the time of one library call computing the same
   function where there is one: ragged paged attention (granite-3.2-8b's
   GQA widths in float32 and bfloat16, zamba2-2.7b's MHA at hd 80 in
   bfloat16), the grouped LoRA delta (granite's Q and K/V widths in
   float32 and bfloat16; in bfloat16 the fused SSM input projection of
   mamba2 and zamba2 and zamba2's Q/K/V), the ragged SSD scan (float32,
   mamba2's N = 128 and zamba2's N = 64);
3. the main paths at full width, random weights from a seed, each
   serving the paper's base → aLoRA pipeline through the mixed step with
   every kernel count set to 0 just before and read just after:
   granite-3.2-8b (attention), mamba2-2.7b (pure SSM) and zamba2-2.7b
   (hybrid), the SSM models reusing the base requests' state snapshots;
   a decode-window profile follows granite and mamba2;
4. parity of the kernel path: the reduced float32 granite, mamba2 and
   zamba2 with two adapters cycling through one device slot, the same
   weights and the same pipeline on the card and on the CPU — identical
   tokens, prefix-cache hits (KV blocks and state snapshots),
   ``state_reused`` and adapter evictions.

``PERF.md`` gives its run time on one H100, the kernels' build included.

The line before the last is the ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``.  The script imports nothing
of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import gc
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


def check_attention(torch, cfgs, timer, gen):
    """Ragged paged attention against its plain version at granite's
    widths (GQA: H 32, KV 8, hd 128; float32 with and without a sliding
    window, and bfloat16) and zamba2's (MHA: H = KV = 32, hd 80;
    bfloat16).  Results are keyed "float32", "bfloat16" (granite) and
    "zamba2_bfloat16"."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import (
        ragged_paged_attention, ragged_paged_attention_ref)
    res = {}
    for arch, dtype_name in (("granite", "float32"), ("granite", "bfloat16"),
                             ("zamba2", "bfloat16")):
        cfg = cfgs[arch]
        key = dtype_name if arch == "granite" else f"{arch}_{dtype_name}"
        label = (f"{key} (H {cfg.num_heads}, KV {cfg.num_kv_heads}, hd "
                 f"{cfg.head_dim})")
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
            fail(f"ragged_paged_attention {label}: max|err| {err}, "
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
        if key == "bfloat16":
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
        res[key] = entry
        print(f"  ragged_paged_attention {label}: max|err| {err:.3e} "
              f"(row rel {row_rel:.3e}, tol {TOL[dtype_name]}; rel to the "
              f"batch's max {rel:.3e})", flush=True)
        if "ms" in entry:
            print(f"    kernel {entry['ms']:.3f} ms, plain "
                  f"{entry['plain_ms']:.3f} ms, library "
                  f"{entry['library_ms']:.3f} ms, bound "
                  f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})",
                  flush=True)
        del a, args, got, want, again
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


def lora_cases(cfgs):
    """(key, dtype, d, out) of every shape the main paths give the
    grouped LoRA delta: granite's Q and K/V projections (float32 and
    bfloat16), the fused SSM input projection of mamba2 and zamba2, and
    zamba2's Q/K/V (bfloat16)."""
    from repro_torch.models.ssm import in_proj_dim
    g, m, z = cfgs["granite"], cfgs["mamba2"], cfgs["zamba2"]
    cases = [(f"{dt}_out{out}", dt, g.d_model, out)
             for dt in ("float32", "bfloat16")
             for out in (g.num_heads * g.head_dim,
                         g.num_kv_heads * g.head_dim)]
    cases += [(f"bfloat16_mamba2_in_proj_out{in_proj_dim(m)}", "bfloat16",
               m.d_model, in_proj_dim(m)),
              (f"bfloat16_zamba2_in_proj_out{in_proj_dim(z)}", "bfloat16",
               z.d_model, in_proj_dim(z)),
              (f"bfloat16_zamba2_qkv_out{z.num_heads * z.head_dim}",
               "bfloat16", z.d_model, z.num_heads * z.head_dim)]
    return cases


def check_lora(torch, cfgs, timer, gen):
    from repro_torch.kernels.ragged_lora import (ragged_grouped_lora,
                                                 ragged_grouped_lora_ref)
    T, r, S = 128, 32, 3
    active = [1, 2]                 # 3 resident slots, 2 active
    idx = torch.tensor([0, 1, 2, 3] * (T // 4), dtype=torch.int32)
    idx = idx[torch.randperm(T, generator=gen)]
    res = {}
    for key, dtype_name, d, out_dim in lora_cases(cfgs):
        dtype = getattr(torch, dtype_name)
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
            fail(f"ragged_grouped_lora {key} (d {d}): max|err| {err} = {rel} "
                 f"of max|plain| > {TOL[dtype_name]}")
        inactive = (ii == 0) | (ii == 3)
        if bool(got[inactive].float().abs().max() != 0):
            fail("ragged_grouped_lora: slot 0 or an inactive slot "
                 "leaked into the delta")
        res[key] = {"d": d, "out": out_dim, "max_abs_err": err,
                    "rel_err": rel, "row_rel_err": row_rel,
                    "tol": TOL[dtype_name]}
        msg = ""
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
            msg = (f"; kernel {res[key]['ms']:.3f} ms, plain "
                   f"{res[key]['plain_ms']:.3f} ms, bound {bound_ms:.5f} ms")
        print(f"  ragged_grouped_lora {key} (d {d}): max|err| {err:.3e} "
              f"(rel {rel:.3e}, tol {TOL[dtype_name]}; largest row rel "
              f"{row_rel:.3e}){msg}", flush=True)
    return res


def scan_inputs(torch, H, N, P, gen, T=128, S=9):
    """A main-path mixed batch of the SSM layers at T = 128: 6 decode
    singletons (each a segment start reading its run slot's state), a
    64-row prefill chunk continuing a request from its live state, a
    48-row first chunk, and 10 padded rows on the dump slot (S - 1).
    Random finite entry states, dA <= 0."""
    starts = torch.zeros(T, dtype=torch.int32)
    slots = torch.full((T,), S - 1, dtype=torch.int32)
    segs = [(t, 1, t) for t in range(6)] + [(6, 64, 6), (70, 48, 7)]
    for t0, n, slot in segs:
        starts[t0] = 1
        slots[t0:t0 + n] = slot
    n_real = 6 + 64 + 48
    starts[n_real:] = 1
    dt = torch.rand((T, H), generator=gen) * 0.1
    dA = -dt * torch.rand((H,), generator=gen)[None] * 8
    x = torch.randn((T, H, P), generator=gen)
    B = torch.randn((T, H, N), generator=gen)
    C = torch.randn((T, H, N), generator=gen)
    init = torch.randn((S, H, N, P), generator=gen)
    args = tuple(a.to("cuda") for a in (x, B, C, dA, dt, starts, slots,
                                         init))
    # the entry rows this batch's segment starts read
    n_init = len({int(slots[t]) for t in range(T) if starts[t]})
    return args, n_init


def check_ssd_scan(torch, timer, gen):
    """The ragged SSD scan against its plain version at mamba2's (H 80,
    N 128, P 64) and zamba2's (N 64) widths.  Both are float32 and differ
    only in the order of the sum over n: y within 1e-4 of each token
    row's max |plain|, the states within 1e-4 of each (token, head)
    row's max |plain|."""
    from repro_torch.kernels.ssd_chunk import (ragged_ssd_chunk_scan,
                                               ragged_ssd_scan_ref)
    res = {}
    for arch, N in (("mamba2", 128), ("zamba2", 64)):
        H, P = 80, 64
        args, n_init = scan_inputs(torch, H, N, P, gen)
        y, st = ragged_ssd_chunk_scan(*args)
        yr, sr = ragged_ssd_scan_ref(*args)
        torch.cuda.synchronize()
        T = y.shape[0]
        err_y, _, row_y = rel_err(y, yr)
        err_s, _, row_s = rel_err(st.reshape(T * H, N * P),
                                  sr.reshape(T * H, N * P))
        tol = TOL["float32"]
        if row_y > tol or row_s > tol:
            fail(f"ragged_ssd_chunk_scan N={N}: y max|err| {err_y} ({row_y} "
                 f"of a row's max|plain|), states {err_s} ({row_s}) > {tol}")
        print(f"  ragged_ssd_chunk_scan float32 {arch} (H {H}, N {N}, P {P}, "
              f"T {T}): y max|err| {err_y:.3e} (row rel {row_y:.3e}), "
              f"states {err_s:.3e} (row rel {row_s:.3e}), tol {tol}",
              flush=True)
        # bytes: every input once (the entry rows this batch's segment
        # starts read), y and the post-token states written once; four
        # float32 operations per (token, head, n, p)
        nbytes = 4 * (T * H * P + 2 * T * H * N + 2 * T * H + 2 * T
                      + n_init * H * N * P + T * H * P + T * H * N * P)
        ops = 4 * T * H * N * P
        bound_ms, bound_by = bound(nbytes, ops, "float32")
        res[arch] = {"N": N, "max_abs_err": max(err_y, err_s),
                     "max_abs_err_y": err_y, "max_abs_err_states": err_s,
                     "row_rel_err_y": row_y, "row_rel_err_states": row_s,
                     "tol": tol,
                     "ms": timer(lambda: ragged_ssd_chunk_scan(*args)),
                     "plain_ms": timer(lambda: ragged_ssd_scan_ref(*args),
                                       n=5, warmup=1),
                     "library_ms": None, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bytes": nbytes, "ops": ops}
        print(f"    kernel {res[arch]['ms']:.3f} ms, plain "
              f"{res[arch]['plain_ms']:.3f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
        del args, y, st, yr, sr
    return res


# ---------------------------------------------------------------------------
# phases 3 and 4: the engine
# ---------------------------------------------------------------------------
def reset_counts():
    from repro_torch.kernels import paged_attention, ragged_lora, ssd_chunk
    paged_attention.ragged_paged_attention.launches = 0
    ragged_lora.ragged_grouped_lora.launches = 0
    ssd_chunk.ragged_ssd_chunk_scan.launches = 0


def read_counts():
    """Launches since ``reset_counts``: attention, LoRA, SSD scan."""
    from repro_torch.kernels import paged_attention, ragged_lora, ssd_chunk
    return (paged_attention.ragged_paged_attention.launches,
            ragged_lora.ragged_grouped_lora.launches,
            ssd_chunk.ragged_ssd_chunk_scan.launches)


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


def main_path(torch, arch: str, profile: bool):
    """Serve ``arch`` at full width (random weights from a seed, one
    rank-32 aLoRA adapter) through the base → aLoRA pipeline and hold the
    launch counts, the reuse and the drained pools to what the path must
    give; with ``profile``, then time a decode window."""
    from repro_torch.configs import SSM, get_config
    from repro_torch.core.alora import AdapterSpec, init_adapter_weights
    from repro_torch.models.layers import padded_vocab
    from repro_torch.models.model import init_params
    from repro_torch.serving import Engine

    cfg = get_config(arch)
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
    n_attn, n_lora, n_scan = read_counts()
    steps = eng.runner.call_counts["mixed_step"]
    ids = res.base_ids + res.eval_ids
    outs = [eng.request(i).output_tokens for i in ids]
    emitted = sum(len(o) for o in outs)
    hits = [eng.request(i).n_cache_hit_tokens for i in res.eval_ids]
    reused = [eng.request(i).state_reused for i in res.eval_ids]
    print(f"  mixed steps {steps}, engine steps {len(step_ms)}, step ms "
          f"mean {statistics.mean(step_ms):.3f} median "
          f"{statistics.median(step_ms):.3f}, tokens emitted {emitted}, "
          f"eval n_cache_hit_tokens {hits}, state_reused {reused}, peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    print(f"  launches: ragged_paged_attention {n_attn}, "
          f"ragged_grouped_lora {n_lora}, ragged_ssd_chunk_scan {n_scan}",
          flush=True)
    vpad = padded_vocab(cfg)
    for rid, o in zip(ids, outs):
        want = 32 if rid in res.base_ids else 8
        if len(o) != want or not all(0 <= t < vpad for t in o):
            fail(f"request {rid}: tokens {o} are not {want} ids < {vpad}")
    if min(hits) < 256:
        fail(f"an eval request reused fewer than 256 tokens: {hits}")
    Ls = cfg.pattern().count(SSM)
    La = cfg.num_layers - Ls
    if Ls and not all(reused):
        fail(f"an eval request did not restore a state snapshot: {reused}")
    want_counts = (La * steps, (3 * La + Ls) * steps, Ls * steps)
    if (n_attn, n_lora, n_scan) != want_counts:
        fail(f"launch counts {(n_attn, n_lora, n_scan)} != {want_counts} "
             f"for {steps} mixed steps of {La} attention and {Ls} SSM "
             "layers")
    for name, mgr in (("KV blocks", eng.kv_mgr), ("state slots",
                                                  eng.st_mgr)):
        if mgr is not None and (mgr.num_free() != mgr.num_blocks
                                or any(m.ref for m in mgr.meta)):
            fail(f"{name} leaked after the drain")
    if (eng.kv_mgr is None) != (La == 0) or (eng.st_mgr is None) != (Ls == 0):
        fail("the engine's managers do not match its layer kinds")
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
    summary = {"arch": arch, "steps": steps,
               "step_ms_mean": statistics.mean(step_ms),
               "step_ms_median": statistics.median(step_ms),
               "tokens_emitted": emitted, "eval_cache_hits": hits,
               "eval_state_reused": reused,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": {"ragged_paged_attention": n_attn,
                            "ragged_grouped_lora": n_lora,
                            "ragged_ssd_chunk_scan": n_scan},
               "phase_ms": phase_ms}
    if arch == "granite-3.2-8b":
        # the per-step host-embedding upload the assembly mirrors from
        # the reference: a (128, d) float32 pinned buffer, non_blocking
        host = torch.empty((128, cfg.d_model), dtype=torch.float32,
                           pin_memory=True)
        up = Timer(torch)(lambda: host.to("cuda", non_blocking=True))
        print(f"  host-embed upload (128 x {cfg.d_model} fp32): {up:.4f} ms",
              flush=True)
        summary["host_embed_upload_ms"] = up
    if profile:
        summary["decode_profile"] = profile_decode(torch, eng, cfg)
    # the timed step wrapper refers back to the engine: collect the cycle
    # so the next model finds the card empty
    del eng, params, adapter
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def profile_decode(torch, eng, cfg, n_steps: int = 8):
    """Where a steady decode step's time goes: 4 running requests with
    256-token contexts, n_steps timed plainly, then n_steps under
    torch.profiler for the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import SSM
    from repro_torch.models.ssm import ssm_dims
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
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
    # device operations (kernels, copies, memsets) per step
    ops_per_step = sum(e.count for e in kernels) / n_steps
    scan_ms = sum(dev_us(e) for e in kernels
                  if "ragged_ssd_scan" in e.key) / 1e3 / n_steps
    state_bytes = 0
    if cfg.ssm is not None:
        _, nh, _ = ssm_dims(cfg)
        state_bytes = cfg.pattern().count(SSM) * 4 * nh \
            * cfg.ssm.state_dim * cfg.ssm.head_dim * 4
    per_step = lambda us: us / 1e3 / n_steps  # noqa: E731
    # kernels whose names share a prefix (template instances) are summed
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.key[:90], (0.0, 0))
        by_name[e.key[:90]] = (ms + per_step(dev_us(e)), n + e.count / n_steps)
    top_dev = sorted(by_name.items(), key=lambda kv: kv[1][0],
                     reverse=True)[:10]
    # device time of the copies by input shape (one ``aten::copy_`` per
    # cast, ``.contiguous()`` or ``.to()``), so a copy kernel's time is
    # told apart by what it copied
    copies = {}
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key == "aten::copy_":
            us = getattr(e, "device_time_total", None) \
                or getattr(e, "cuda_time_total", 0) or 0
            copies[str(e.input_shapes)[:90]] = (per_step(us),
                                                e.count / n_steps)
    top_copies = sorted(copies.items(), key=lambda kv: kv[1][0],
                        reverse=True)[:8]
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
           else None, "device_ops_per_step": ops_per_step,
           "scan_device_ms_per_step": scan_ms,
           "scan_share_of_busy": scan_ms / busy_ms if busy_ms else None,
           # the scan's post-token state writes: one row per running
           # request (T = 4) per SSM layer, float32
           "scan_state_write_bytes_per_step": state_bytes,
           "host_us_per_eager_launch": launch_us,
           "top_device_ms_per_step": dict(top_dev),
           "copy_device_ms_per_step_by_shape": dict(top_copies),
           "top_host_ms_per_step_profiled": {
               e.key[:70]: (per_step(e.self_cpu_time_total), e.count
                            // n_steps) for e in top_host}}
    print(f"  decode step (4 x 256 context): {step_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms/step" if busy_ms else
          f"  decode step: {step_ms:.3f} ms, device time not measured "
          "(the profiler saw no device events)", flush=True)
    print(f"  host us per eager launch: {launch_us:.2f}; device ops per "
          f"step {ops_per_step:.0f}; ragged_ssd_chunk_scan {scan_ms:.3f} "
          f"ms/step, its state writes {state_bytes / 1e6:.1f} MB/step",
          flush=True)
    for k, (v, n) in out["top_device_ms_per_step"].items():
        print(f"    device {v:8.3f} ms/step  {n:7.1f} calls/step  {k}",
              flush=True)
    for k, (v, n) in out["copy_device_ms_per_step_by_shape"].items():
        print(f"    copy   {v:8.3f} ms/step  {n:7.1f} calls/step  {k}",
              flush=True)
    for k, (v, n) in out["top_host_ms_per_step_profiled"].items():
        print(f"    host   {v:8.3f} ms/step  {n:5d} calls/step  {k}",
              flush=True)
    return out


def parity(torch, arch: str):
    """The reduced float32 ``arch`` with two adapters cycling through one
    device slot: the same weights and pipeline on the card and on the CPU
    give identical tokens, prefix-cache hits (KV blocks and state
    snapshots), ``state_reused`` and adapter evictions."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.alora import AdapterSpec, init_adapter_weights
    from repro_torch.models.model import init_params
    from repro_torch.serving import Engine, EngineConfig

    cfg = get_reduced(arch)
    gen = torch.Generator().manual_seed(1)
    params = init_params(gen, cfg, device="cpu")
    # every adapter switch evicts, stages on the side stream and installs
    # in place
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
        reqs = [eng.request(i) for i in res.base_ids + res.eval_ids]
        runs[device] = dict(
            tokens=[r.output_tokens for r in reqs],
            hits=[r.n_cache_hit_tokens for r in reqs],
            state_reused=[r.state_reused for r in reqs],
            kv_hits=eng.kv_mgr.hits if eng.kv_mgr is not None else None,
            state_hits=eng.st_mgr.hits if eng.st_mgr is not None else None,
            evictions=eng.adapter_pool.evictions)
    if runs["cuda"] != runs["cpu"]:
        fail(f"{arch}: card and CPU disagree: {runs}")
    r = runs["cpu"]
    print(f"  {cfg.name} card == CPU: {len(r['tokens'])} requests, KV hits "
          f"{r['kv_hits']}, state hits {r['state_hits']}, state_reused "
          f"{sum(r['state_reused'])}, adapter evictions {r['evictions']}",
          flush=True)
    if cfg.ssm is not None and not any(r["state_reused"]):
        fail(f"{arch}: no request restored a state snapshot")
    return {k: r[k] for k in ("kv_hits", "state_hits", "evictions")}


def kernel_entry(name, source, replaces, launches, steps, check, **extra):
    """One entry of the ``kernels`` line: the fields every kernel has,
    then what is particular to it."""
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "launches_per_step": launches / steps}
    for k in ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms"):
        entry[k] = check[k]
    entry.update(extra)
    return entry


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
    # float32 products and convolutions in full float32 (TF32 off): the
    # SSM layers' float32 rounding points and the reduced float32 parity
    # runs rely on it
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
    cfgs = {"granite": get_config("granite-3.2-8b"),
            "mamba2": get_config("mamba2-2.7b"),
            "zamba2": get_config("zamba2-2.7b")}
    cfg = cfgs["granite"]
    gen = torch.Generator().manual_seed(0)
    timer = Timer(torch)
    attn = check_attention(torch, cfgs, timer, gen)
    lora = check_lora(torch, cfgs, timer, gen)
    scan = check_ssd_scan(torch, timer, gen)
    del timer
    torch.cuda.empty_cache()

    print("[3] main path, full width", flush=True)
    mp = {}
    for arch in ("granite-3.2-8b", "mamba2-2.7b", "zamba2-2.7b"):
        print(f" [3] {arch}", flush=True)
        mp[arch] = main_path(torch, arch,
                             profile=arch != "zamba2-2.7b")

    print("[4] parity, reduced fp32, card vs CPU", flush=True)
    par = {arch: parity(torch, arch)
           for arch in ("granite-3.2-8b", "mamba2-2.7b", "zamba2-2.7b")}

    g, m, z = (mp[a] for a in ("granite-3.2-8b", "mamba2-2.7b",
                               "zamba2-2.7b"))
    a16 = attn["bfloat16"]
    l16 = lora[f"bfloat16_out{cfg.num_heads * cfg.head_dim}"]
    kernels = [
        kernel_entry(
            "ragged_paged_attention",
            "src/repro_torch/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:83",
            g["launches"]["ragged_paged_attention"], g["steps"], a16,
            row_rel_err=a16["row_rel_err"],
            max_abs_err_fp32=attn["float32"]["max_abs_err"],
            max_abs_err_fp32_window=attn["float32"]["max_abs_err_window"],
            tol_fp32=attn["float32"]["tol"],
            launches_zamba2=z["launches"]["ragged_paged_attention"],
            decode8={k: a16["decode8"][k] for k in
                     ("ms", "plain_ms", "library_ms", "bound_ms",
                      "bound_by")},
            zamba2={k: attn["zamba2_bfloat16"][k] for k in
                    ("max_abs_err", "row_rel_err", "tol", "ms", "plain_ms",
                     "library_ms", "bound_ms", "bound_by")}),
        kernel_entry(
            "ragged_grouped_lora", "src/repro_torch/csrc/ragged_lora.cu",
            "src/repro/kernels/ragged_lora.py:82",
            g["launches"]["ragged_grouped_lora"], g["steps"], l16,
            max_abs_err_fp32=max(v["max_abs_err"] for k, v in lora.items()
                                 if k.startswith("float32")),
            tol_fp32=TOL["float32"],
            launches_mamba2=m["launches"]["ragged_grouped_lora"],
            launches_zamba2=z["launches"]["ragged_grouped_lora"],
            ms_out1024=lora["bfloat16_out1024"]["ms"],
            bound_ms_out1024=lora["bfloat16_out1024"]["bound_ms"],
            cases={k: {f: v[f] for f in ("d", "out", "max_abs_err",
                                         "rel_err", "tol", "ms", "bound_ms")
                       if f in v} for k, v in lora.items()}),
        kernel_entry(
            "ragged_ssd_chunk_scan", "src/repro_torch/csrc/ssd_chunk.cu",
            "src/repro/kernels/ssd_chunk.py:178",
            m["launches"]["ragged_ssd_chunk_scan"], m["steps"],
            scan["mamba2"],
            row_rel_err_y=scan["mamba2"]["row_rel_err_y"],
            row_rel_err_states=scan["mamba2"]["row_rel_err_states"],
            launches_zamba2=z["launches"]["ragged_ssd_chunk_scan"],
            launches_per_step_zamba2=z["launches"]["ragged_ssd_chunk_scan"]
            / z["steps"],
            n64={k: scan["zamba2"][k] for k in
                 ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}),
    ]
    print(json.dumps({"main_path": mp, "parity": par, "card": card,
                      "seconds": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
