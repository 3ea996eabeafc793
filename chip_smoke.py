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
   bfloat16, and in both types stablelm-12b's hd 160, nemotron-4-15b's
   G = 6 and starcoder2-3b's G = 12 under its 4096-token window on a
   T = 128 chunk at positions 4,480..4,607 over a 512-block table,
   granite-moe-1b's G = 2 at hd 64, phi-3-vision's MHA at hd 96 and
   whisper-large-v3's MHA 20/20/64, each also at a T = 8 decode step;
   phi3.5-moe's widths are granite's), the
   grouped LoRA delta (its fused Q/K/V entry at granite's widths in
   float32 and bfloat16 and at zamba2's, the four dense families',
   granite-moe's, phi-3-vision's and whisper's (1280 -> 1280 x 3) in
   bfloat16, its one-pair entry at
   the SSM input projections of mamba2 and zamba2 in bfloat16; timed at
   T = 128 and at a T = 4 decode step),
   the ragged SSD scan (float32, mamba2's N = 128 and zamba2's N = 64,
   with the runner's kept rows; timed at T = 128 and T = 4), each time
   split by the profiler into the call's CUDA kernels, and attention timed
   again with one decode row's context at 8,000 tokens over a 512-block
   table (the grid's splits and scratch at the engine's default pool);
   ragged paged attention
   on a batch that reaches every tile and split edge (contexts around a
   split boundary, a window across one, a prefill chunk longer than a
   query tile and off its grid, interleaved rows, padded rows sharing a
   tile) at granite's, zamba2's and the dense families' widths and at hd
   64, 96 and 160 with G 3, 6 and 12 (query tiles of 21, 10 and 5 rows),
   in both types; the fused
   Q/K/V LoRA entry at T = 1, 4, 37 and 128 and ranks 8 and 256 in both
   types (NaN in slot 0 and in an inactive slot must change no output,
   rows on no active slot must be exact zeros); the ragged scan with kept
   rows unsorted, repeated and inside a segment, and NaN in every entry
   row no segment start reads (no output may change); and the kernel
   bench's three kernels at small shapes that reach every masked edge,
   in each type they take: decode paged attention (lengths ending inside
   a block, with and without a 7-token window, and lengths around a
   split boundary, with and without a 24-token window), the fused aLoRA
   QKV projection (T 1, 100, 130 and 300 across both branches of its
   plan, d 264 and outputs 200 and 6144 off its tiles, ranks 8 and 32;
   NaN in slot 0 and in an adapter no row is on, and the indices -1 and
   n, all of which must change no output) and the dense SSD chunk scan
   (S 70 and 130 off its chunks, P 40 off its column slices, N 32, 64
   and 128, with Bt * H below and above the 132 SMs); then the MoE layer
   (masked dense: plain batched products, no kernel of its own) against
   its plain version that adds the experts one after another, bf16 at
   granite-moe's and phi3.5-moe's full widths, T = 128 and 4, timed
   beside the bytes of the experts its routes touch, of every expert, and
   its operations; then decode attention and the fused aLoRA projection
   at the sequential step's serving shapes (bf16: granite's, zamba2's
   and whisper's decode batch of 4; their Q projections and granite's
   K/V width at T = 4, 64 and 128 on one rank-32 adapter slot);
3. the main paths at full width, random weights from a seed, each
   serving the paper's base → aLoRA pipeline through the mixed step with
   every kernel count set to 0 just before and read just after:
   granite-3.2-8b (attention), mamba2-2.7b (pure SSM), zamba2-2.7b
   (hybrid), the dense families stablelm-12b, minitron-4b,
   nemotron-4-15b and starcoder2-3b, the MoE models granite-moe-1b-a400m
   and phi3.5-moe (24 of its 32 layers: all 32 do not fit on the card),
   phi-3-vision-4.2b on images (576 patch embeddings under
   pseudo-tokens, then 256 text tokens; each eval reuses ≥ 832 tokens
   and a request on another image none) and whisper-large-v3 on audio
   (32 encoder and 32 decoder layers, 1500 frames of N(0, 0.02) per
   request salted by their digest, encoded once at admission into the
   request's run slot; each eval reuses ≥ 256 tokens and a request on
   another audio none), one model on the card at a time,
   the SSM models reusing the base requests' state snapshots (one fused
   Q/K/V LoRA call and one attention call per attention layer and step,
   one in-projection call and one scan per SSM layer and step); each run
   records each step's packed and adapted tokens; starcoder2 then serves
   a 4,608-token prompt, so every row past position 4,096 runs under its
   window, and its eval request reuses ≥ 4,096 tokens; a decode-window
   profile follows every model but zamba2, beside the model's
   weight-read bound (on the MoE models also beside the bytes the step's
   routes touch, and with no copy of an expert weight in the step; on
   whisper beside the bytes a decode step reads, its encoder K/V counted
   in the model dtype, with no copy of encoder K/V in the step, and one
   layer's cross-attention timed on the runner's float32 pools and on
   model-dtype copies of the same values); granite-3.2-8b, zamba2-2.7b
   and whisper-large-v3 then serve the same pipeline again on the same
   weights through the sequential execution mode (one call per decode
   batch and per prefill chunk): B4 once per attention layer of a decode call, B6 once per
   Q/K/V projection, B2's one-pair entry once per SSM layer, counted, the
   same reuse as the mixed run, the wall ms per call, and how many
   generated tokens agree with the mixed run's (bf16, no limit);
4. parity of the kernel path: the reduced float32 granite, mamba2,
   zamba2, dense families (minitron and nemotron at G = 3, starcoder2
   with 150-token prompts past its 128-token window), MoE models (with
   their routes' smallest top-k margin), phi-3-vision (on images of
   its 16 patches) and whisper (on audio of its 64 frames), then granite,
   mamba2, zamba2 and whisper in the sequential mode (with their logits'
   smallest top-1/top-2 margin), with two adapters
   cycling through one device slot, the same
   weights and the same pipeline on the card and on the CPU — identical
   tokens, prefix-cache hits (KV blocks and state snapshots),
   ``state_reused`` and adapter evictions, and each sequential run's
   tokens, hits and ``state_reused`` equal to the mixed run's on the
   card; then a reduced granite engine
   on the card asked for adapter slot rank 48 holds the LoRA kernel's
   bucket 64 and serves to the end, and one given a rank-300 adapter
   raises at construction;
5. the kernel-bench entry point (``repro_torch.kernels.bench``) at full
   width, with every kernel count set to 0 just before and read just
   after: decode attention (granite's GQA, contexts 256–4096, bf16, and
   float32 with a 24-token window), the fused aLoRA QKV projection
   (granite's d 4096 → 6144, four rank-32 adapters; bf16 at T = 128 and
   512, float32 at 128) and the dense SSD chunk scan (float32, two rows
   of 2048 tokens, H 80, P 64, N = 128 and 64) must each launch, and each
   must stay within tolerance of its plain version; the bench times each
   against its plain version, its bound and its yardstick (by events and
   by the profiler's device time).  Then a NaN
   written into the block past every length must leave decode
   attention's output unchanged at the bench's full-width cases.

``PERF.md`` gives its run time on one H100, the kernels' build included.

The line before the last is the ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``.  The script imports nothing
of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# max |err| / max |plain|, taken per output row for attention (whose rows
# differ in scale by the context length) and over the whole output for
# the LoRA delta (whose rows share one scale)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TOL_OF = "max |err| / max |plain|, of each row for attention"
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
    """The least time the card could take, in ms, and what sets it: the
    larger of the bytes over the HBM rate and the operations over the
    type's dense peak (the rates of the port's kernel bench)."""
    import torch

    from repro_torch.kernels.bench import bound_ms
    return bound_ms(nbytes, ops, getattr(torch, dtype))


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


# the dense families' B1 cases beside granite's and zamba2's: stablelm's
# hd 160 (G 4), nemotron's G 6 and starcoder2's G 12 with its window
DENSE_ATTN = ("stablelm", "nemotron", "starcoder2")
# the dense families' short names (phase 2) and registry ids (phases 3-4)
DENSE = ("stablelm", "minitron", "nemotron", "starcoder2")
DENSE_ARCHS = ("stablelm-12b", "minitron-4b", "nemotron-4-15b",
               "starcoder2-3b")
# the mixture-of-experts and vision-prefix families, likewise
MOE_VLM = ("granitemoe", "phimoe", "phivision")
MOE_VLM_ARCHS = ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b",
                 "phi-3-vision-4.2b")
# their B1 and B2 cases: granite-moe's 16/8/64 (G 2) and phi-3-vision's
# MHA 32/32/96; phi3.5-moe's attention (32/8/128) and Q/K/V widths (4096
# -> 4096/1024/1024) are granite-3.2-8b's, whose cases cover it
NEW_ATTN = ("granitemoe", "phivision")
# the encoder-decoder: whisper-large-v3 (B1 at MHA 20/20/64, B2's fused
# entry at 1280 -> 1280 x 3)
ENCDEC = ("whisper",)
ENCDEC_ARCH = "whisper-large-v3"
# the models served again through the sequential execution mode
SEQ_ARCHS = ("granite-3.2-8b", "zamba2-2.7b", ENCDEC_ARCH)
# phi3.5-moe on one 80 GB card: 24 of its 32 layers (all 32 are 83.7 GB
# of bf16 weights)
PHIMOE_LAYERS = 24
IMAGE_TOKEN = 1                 # the pseudo-token id under every patch


def check_attention(torch, cfgs, timer, gen):
    """Ragged paged attention against its plain version at granite's
    widths (GQA: H 32, KV 8, hd 128; float32 with and without a sliding
    window, and bfloat16), zamba2's (MHA: H = KV = 32, hd 80; bfloat16)
    and, in both types, stablelm's (H 32, KV 8, hd 160), nemotron's (H
    48, KV 8: G 6), starcoder2's (H 24, KV 2: G 12, on a T = 128 chunk
    at positions 4,480..4,607 under its 4096-token window; table of 512
    blocks, 32 splits), granite-moe's (H 16, KV 8, hd 64: G 2) and
    phi-3-vision's (MHA: H = KV = 32, hd 96) and whisper's decoder (MHA:
    H = KV = 20, hd 64).  Each of those six is also checked and timed at
    a T = 8 decode step.  Results are keyed
    "float32", "bfloat16" (granite), "zamba2_bfloat16" and
    "{family}_{dtype}"."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import (
        ragged_paged_attention, ragged_paged_attention_ref)
    res = {}
    cases = [("float32", "granite", "float32"),
             ("bfloat16", "granite", "bfloat16"),
             ("zamba2_bfloat16", "zamba2", "bfloat16")] + [
        (f"{arch}_{dt}", arch, dt) for arch in DENSE_ATTN + NEW_ATTN + ENCDEC
        for dt in ("float32", "bfloat16")]
    for key, arch, dtype_name in cases:
        cfg = cfgs[arch]
        window = cfg.sliding_window
        label = (f"{key} (H {cfg.num_heads}, KV {cfg.num_kv_heads}, hd "
                 f"{cfg.head_dim}{f', window {window}' if window else ''})")
        dtype = getattr(torch, dtype_name)
        if window:
            a, d8 = window_inputs(torch, cfg, dtype, gen)
        else:
            a = attention_inputs(torch, cfg, dtype, gen)
            # a pure-decode step of 8 running requests: T = 8, so only
            # T x KV thread blocks for 132 SMs
            d8 = dict(a, q=a["q"][:8].contiguous(),
                      req_rows=a["req_rows"][:8].contiguous(),
                      q_lens=a["q_lens"][:8].contiguous(), n_real=8,
                      lens=a["lens"][:8], rows=a["rows"][:8])
        args = (a["q"], a["k_pool"], a["v_pool"], a["block_tables"],
                a["req_rows"], a["q_lens"])
        got = ragged_paged_attention(*args, window=window)
        want = ragged_paged_attention_ref(*args, window=window)
        torch.cuda.synchronize()
        n = a["n_real"]
        err, rel, row_rel = rel_err(got, want, slice(0, n))
        if row_rel > TOL[dtype_name]:
            fail(f"ragged_paged_attention {label}: max|err| {err}, "
                 f"{row_rel} of a row's max|plain| > {TOL[dtype_name]}")
        if key == "float32":
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
        if n < got.shape[0] and bool(got[n:].float().abs().max() != 0):
            fail("ragged_paged_attention: q_lens == 0 rows are not zero")
        # the kernel never reads past q_len: NaN in the dump block
        # (padding entries of every table) must not reach any row
        a["k_pool"][-1] = float("nan")
        a["v_pool"][-1] = float("nan")
        again = ragged_paged_attention(*args, window=window)
        torch.cuda.synchronize()
        if not torch.equal(again, got):
            fail(f"ragged_paged_attention {label} reads past q_len (dump "
                 "block)")
        a["k_pool"][-1] = 0.0
        a["v_pool"][-1] = 0.0
        entry = {"H": cfg.num_heads, "KV": cfg.num_kv_heads,
                 "hd": cfg.head_dim, "window": window, "T": got.shape[0],
                 "max_abs_err": err, "rel_err": rel, "row_rel_err": row_rel,
                 "tol": TOL[dtype_name]}
        if key == "float32":
            entry.update(window=WINDOW, max_abs_err_window=err_w,
                         row_rel_err_window=row_rel_w)
        if dtype_name == "bfloat16" or arch in DENSE_ATTN + NEW_ATTN + ENCDEC:
            entry.update(time_attention(torch, F, timer, a, args, dtype_name,
                                        ragged_paged_attention,
                                        ragged_paged_attention_ref))
        if key == "bfloat16" or arch in DENSE_ATTN + NEW_ATTN + ENCDEC:
            args8 = (d8["q"], d8["k_pool"], d8["v_pool"], d8["block_tables"],
                     d8["req_rows"], d8["q_lens"])
            got8 = ragged_paged_attention(*args8, window=window)
            want8 = ragged_paged_attention_ref(*args8, window=window)
            torch.cuda.synchronize()
            _, _, row_rel8 = rel_err(got8, want8)
            if row_rel8 > TOL[dtype_name]:
                fail(f"ragged_paged_attention {label} decode T=8: "
                     f"{row_rel8} of a row's max|plain| > {TOL[dtype_name]}")
            entry["decode8"] = time_attention(
                torch, F, timer, d8, args8, dtype_name,
                ragged_paged_attention, ragged_paged_attention_ref)
            entry["decode8"]["row_rel_err"] = row_rel8
            del got8, want8
        if key == "bfloat16":
            entry["long"] = check_long_context(torch, F, timer, a, gen)
        res[key] = entry
        print(f"  ragged_paged_attention {label}: max|err| {err:.3e} "
              f"(row rel {row_rel:.3e}, tol {TOL[dtype_name]}; rel to the "
              f"batch's max {rel:.3e})", flush=True)
        for name, e in (("", entry), ("decode T=8: ",
                                      entry.get("decode8", {})),
                        ("long context: ", entry.get("long", {}))):
            if "ms" in e:
                print(f"    {name}kernel {e['ms']:.4f} ms (device "
                      + ", ".join(f"{k} {v:.4f}" for k, v in
                                  e["device_split_ms"].items())
                      + f"), plain {e['plain_ms']:.3f} ms, library "
                      f"{e['library_ms']:.4f} ms, bound "
                      f"{e['bound_ms']:.4f} ms ({e['bound_by']})",
                      flush=True)
        del a, d8, args, got, want, again
    return res


def window_inputs(torch, cfg, dtype, gen, bs=16, nbb=512):
    """starcoder2's sliding-window batches over the engine's 512-block
    table (32 splits of 256 tokens): a T = 128 prefill chunk at positions
    4,480..4,607 of one request (each row's window of ``cfg``'s 4096
    keys starts inside a split), and a T = 8 decode step of eight
    requests with contexts 4,097..8,000 (all past the window).  Returns
    the two batches as :func:`attention_inputs` does."""
    contexts = [4097, 4300, 4608, 5000, 5500, 6000, 7000, 8000, 4608]
    KV, hd, H = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    nblk = [-(-c // bs) for c in contexts]
    NB = sum(nblk) + 1
    dump = NB - 1
    perm = torch.randperm(NB - 1, generator=gen).tolist()
    tables, used = [], 0
    for n in nblk:
        tables.append(perm[used:used + n])
        used += n
    bt = torch.full((len(contexts), nbb), dump, dtype=torch.int32)
    for r, t in enumerate(tables):
        bt[r, :len(t)] = torch.tensor(t, dtype=torch.int32)
    dev = "cuda"
    kp = torch.randn((NB, bs, KV, hd), generator=gen).to(dev, dtype)
    vp = torch.randn((NB, bs, KV, hd), generator=gen).to(dev, dtype)
    out = []
    for rows, lens in (([8] * 128, list(range(4481, 4609))),
                       (list(range(8)), contexts[:8])):
        T = len(rows)
        out.append(dict(
            q=torch.randn((T, H, hd), generator=gen).to(dev, dtype),
            k_pool=kp, v_pool=vp, block_tables=bt.to(dev),
            req_rows=torch.tensor(rows, dtype=torch.int32, device=dev),
            q_lens=torch.tensor(lens, dtype=torch.int32, device=dev),
            n_real=T, tables=tables, lens=lens, rows=rows,
            window=cfg.sliding_window))
    return out


def time_attention(torch, F, timer, a, args, dtype_name, kernel, plain):
    from repro_torch.kernels.bench import device_split
    q = a["q"]
    T, H, hd = q.shape
    _, bs, KV, _ = a["k_pool"].shape
    es = q.element_size()
    n = a["n_real"]
    window = a.get("window", 0)
    lens, rows, tables = a["lens"], a["rows"], a["tables"]
    blocks = set()
    ops = 0
    for t in range(n):
        lo = max(0, lens[t] - window) if window else 0
        blocks.update(tables[rows[t]][lo // bs:-(-lens[t] // bs)])
        ops += 4 * H * hd * (lens[t] - lo)           # QK^T and PV
    nbytes = 2 * T * H * hd * es + 2 * len(blocks) * bs * KV * hd * es \
        + 4 * (a["block_tables"].numel() + 2 * T)
    bound_ms, bound_by = bound(nbytes, ops, dtype_name)
    kw = {"window": window}
    ms = timer(lambda: kernel(*args, **kw))
    # device ms per launch of each CUDA kernel of the call (tile, merge)
    split = device_split(SimpleNamespace(args=args, kwargs=kw), kernel, timer)
    plain_ms = timer(lambda: plain(*args, **kw))
    # library yardstick: scaled_dot_product_attention over K/V gathered
    # per token beforehand, with the same mask (timed here only)
    nbb = a["block_tables"].shape[1]
    bt = a["block_tables"].long()[a["req_rows"].long()]
    k = a["k_pool"][bt].reshape(T, nbb * bs, KV, hd).transpose(1, 2)
    v = a["v_pool"][bt].reshape(T, nbb * bs, KV, hd).transpose(1, 2)
    k, v = k.contiguous(), v.contiguous()
    pos = torch.arange(nbb * bs, device="cuda")[None, :]
    ql = a["q_lens"][:, None]
    mask = (pos < ql) & (pos >= ql - window) if window else pos < ql
    mask = mask[:, None, None, :]
    qq = q[:, :, None, :]
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        qq, k, v, attn_mask=mask, enable_gqa=True))
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "ops": ops, "device_split_ms": split}


def check_long_context(torch, F, timer, a, gen, ctx=8000, nbb=512):
    """The mixed batch ``a`` with request 0's decode row grown to a
    ``ctx``-token context over a table of ``nbb`` blocks, the engine's
    default pool of 512: the table span, and so the grid's splits and the
    fp32 split scratch, of a long context beside short ones (most blocks
    of the grid exit at once).  Checked against the plain version and
    timed; returns the times with the splits and the scratch's bytes."""
    from repro_torch.kernels.paged_attention import (
        plan, ragged_paged_attention, ragged_paged_attention_ref)
    bs = a["k_pool"].shape[1]
    dump = a["k_pool"].shape[0] - 1
    tables = list(a["tables"])
    tables[0] = torch.randperm(dump, generator=gen)[:-(-ctx // bs)].tolist()
    lens = list(a["lens"])
    lens[0] = ctx
    bt = torch.full((a["block_tables"].shape[0], nbb), dump,
                    dtype=torch.int32)
    for r, t in enumerate(tables):
        bt[r, :len(t)] = torch.tensor(t, dtype=torch.int32)
    d = dict(a, block_tables=bt.to("cuda"), tables=tables, lens=lens,
             q_lens=torch.tensor(lens, dtype=torch.int32, device="cuda"))
    args = (d["q"], d["k_pool"], d["v_pool"], d["block_tables"],
            d["req_rows"], d["q_lens"])
    got = ragged_paged_attention(*args)
    want = ragged_paged_attention_ref(*args)
    torch.cuda.synchronize()
    _, _, row_rel = rel_err(got, want, slice(0, d["n_real"]))
    if row_rel > TOL["bfloat16"]:
        fail(f"ragged_paged_attention long context: {row_rel} of a row's "
             f"max|plain| > {TOL['bfloat16']}")
    del got, want
    q = d["q"]
    p = plan(*q.shape[:2], d["k_pool"].shape[2], q.shape[2], bs, nbb)
    res = time_attention(torch, F, timer, d, args, "bfloat16",
                         ragged_paged_attention, ragged_paged_attention_ref)
    res.update(context=ctx, table_blocks=nbb, row_rel_err=row_rel,
               splits=p.grid[2], grid_blocks=p.grid[0] * p.grid[1]
               * p.grid[2], scratch_bytes=4 * (p.partials[0] * p.partials[1]
                                               * p.partials[2])
               * (p.partials[3] + 2))
    print(f"  ragged_paged_attention long context {ctx} over {nbb} blocks: "
          f"row rel {row_rel:.3e}; {res['splits']} splits, "
          f"{res['grid_blocks']} blocks, scratch "
          f"{res['scratch_bytes'] / 1e6:.1f} MB", flush=True)
    return res


def edge_batch(torch, cfg, dtype, gen):
    """A ragged batch at ``cfg``'s attention widths that reaches every
    tile and split edge of the kernel (splits of 256 tokens; query tiles
    of 64 / G rows): decode rows with contexts 255, 256, 257 and 560 (one
    each side of a split boundary, one ending on a 16-token block); an
    80-row prefill chunk at positions 200..279 packed from row 4 (longer
    than a tile, off the tile grid, across a split boundary); 12 rows of
    two requests interleaved (non-contiguous rows of one request); a
    6-row chunk followed by 4 padded rows (q_lens 0) of the same request
    row, which share its last tile at every M = 64 // G of 64 down to 5
    (it starts at packed row 96).  Table entries past each context point
    at the pool's last block (the dump block)."""
    bs, nb = 16, 48
    KV, hd, H = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    rows, lens = [0, 1, 2, 3], [255, 256, 257, 560]
    rows += [4] * 80
    lens += list(range(201, 281))
    rows += [5, 6] * 6
    lens += [p for i in range(6) for p in (300 + i, 600 + i)]
    rows += [7] * 10
    lens += [11, 12, 13, 14, 15, 16, 0, 0, 0, 0]
    ctx = [255, 256, 257, 560, 280, 305, 605, 16]
    NB = len(ctx) * nb + 1
    perm = torch.randperm(NB - 1, generator=gen).tolist()
    bt = torch.full((len(ctx), nb), NB - 1, dtype=torch.int32)
    used = 0
    for r, n in enumerate(ctx):
        nblk = -(-n // bs)
        bt[r, :nblk] = torch.tensor(perm[used:used + nblk], dtype=torch.int32)
        used += nblk
    T = len(rows)
    dev = "cuda"
    args = (torch.randn((T, H, hd), generator=gen).to(dev, dtype),
            torch.randn((NB, bs, KV, hd), generator=gen).to(dev, dtype),
            torch.randn((NB, bs, KV, hd), generator=gen).to(dev, dtype),
            bt.to(dev), torch.tensor(rows, dtype=torch.int32, device=dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))
    return args, torch.tensor(lens, device=dev) > 0


# (label, H, KV, hd) of the edge batch: granite (G 4) and zamba2 (G 1,
# hd 80), the dense families at full width (stablelm hd 160; minitron,
# nemotron and starcoder2: G 3, 6 and 12, tiles of 21, 10 and 5 rows),
# and the head sizes of the configs still to port (64, 96) crossed with
# the new group sizes
EDGE_SHAPES = (("granite", 32, 8, 128), ("zamba2", 32, 32, 80),
               ("stablelm", 32, 8, 160), ("minitron", 24, 8, 128),
               ("nemotron", 48, 8, 128), ("starcoder2", 24, 2, 128),
               ("hd64_G3", 24, 8, 64), ("hd96_G6", 48, 8, 96),
               ("hd160_G12", 24, 2, 160))


def check_attention_edges(torch, gen):
    """Ragged paged attention on :func:`edge_batch` at every shape of
    ``EDGE_SHAPES``, float32 and bfloat16, with no window and a 24-token
    one (which straddles the split boundary for the context 257): within
    TOL of each live row's max |plain|, zeros on the padded rows, and no
    output changed by NaN in the dump block.  Returns {case: row
    relative error}."""
    from repro_torch.kernels.paged_attention import (
        plan, ragged_paged_attention, ragged_paged_attention_ref)
    res = {}
    for label, H, KV, hd in EDGE_SHAPES:
        shape = SimpleNamespace(num_heads=H, num_kv_heads=KV, head_dim=hd)
        for dtype_name in ("float32", "bfloat16"):
            args, live = edge_batch(torch, shape,
                                    getattr(torch, dtype_name), gen)
            M = plan(args[0].shape[0], H, KV, hd, 16,
                     args[3].shape[1]).tile_rows
            for window in (0, WINDOW):
                key = f"ragged_{label}_{dtype_name}_window{window}"
                got = ragged_paged_attention(*args, window=window)
                want = ragged_paged_attention_ref(*args, window=window)
                torch.cuda.synchronize()
                _, _, row_rel = rel_err(got, want, live)
                if row_rel > TOL[dtype_name]:
                    fail(f"ragged_paged_attention edges {key}: {row_rel} of "
                         f"a row's max|plain| > {TOL[dtype_name]}")
                if bool(got[~live].float().abs().max() != 0):
                    fail(f"ragged_paged_attention edges {key}: q_lens == 0 "
                         "rows are not zero")
                args[1][-1] = float("nan")
                args[2][-1] = float("nan")
                again = ragged_paged_attention(*args, window=window)
                torch.cuda.synchronize()
                args[1][-1] = 0.0
                args[2][-1] = 0.0
                if not torch.equal(again, got):
                    fail(f"ragged_paged_attention edges {key}: NaN in the "
                         "dump block reached the output")
                res[key] = row_rel
                print(f"  {key} (H {H}, KV {KV}, hd {hd}, tiles of {M} "
                      f"rows): {row_rel:.3e} of a row's max|plain| (tol "
                      f"{TOL[dtype_name]}); zero rows and dump-block NaN "
                      "held", flush=True)
            del args, got, want, again
    return res


def lora_cases(cfgs):
    """(key, dtype, d, out widths) of every shape the main paths give the
    grouped LoRA delta: granite's fused Q/K/V (float32 and bfloat16),
    zamba2's, the four dense families', granite-moe's, phi-3-vision's and
    whisper's fused Q/K/V, and the SSM input projection of mamba2 and zamba2
    (bfloat16; one pair)."""
    from repro_torch.models.ssm import in_proj_dim
    g, m, z = cfgs["granite"], cfgs["mamba2"], cfgs["zamba2"]
    qkv = lambda c: (c.num_heads * c.head_dim,  # noqa: E731
                     c.num_kv_heads * c.head_dim, c.num_kv_heads * c.head_dim)
    return [(f"{dt}_qkv", dt, g.d_model, qkv(g))
            for dt in ("float32", "bfloat16")] + [
        ("bfloat16_zamba2_qkv", "bfloat16", z.d_model, qkv(z))] + [
        (f"bfloat16_{a}_qkv", "bfloat16", cfgs[a].d_model, qkv(cfgs[a]))
        for a in DENSE + NEW_ATTN + ENCDEC] + [
        (f"bfloat16_mamba2_in_proj_out{in_proj_dim(m)}", "bfloat16",
         m.d_model, (in_proj_dim(m),)),
        (f"bfloat16_zamba2_in_proj_out{in_proj_dim(z)}", "bfloat16",
         z.d_model, (in_proj_dim(z),))]


def lora_inputs(torch, gen, dtype, T, d, r, widths, idx):
    """x (T, d) and one rank-r stack pair per width over 3 resident slots
    (slot 0 zero), and the 2 active slots [1, 2]."""
    S = 3
    x = torch.randn((T, d), generator=gen).to("cuda", dtype)
    pairs = []
    for out in widths:
        a = torch.randn((S + 1, d, r), generator=gen) / d ** 0.5
        b = torch.randn((S + 1, r, out), generator=gen) * (0.02 / r ** 0.5)
        a[0] = 0
        b[0] = 0
        pairs.append((a.to("cuda", dtype), b.to("cuda", dtype)))
    act = torch.tensor([1, 2], dtype=torch.int32, device="cuda")
    return x, pairs, idx.to("cuda"), act


def lora_call(pairs):
    """The entry point for ``pairs``: the fused Q/K/V one for three."""
    from repro_torch.kernels.ragged_lora import (ragged_grouped_lora,
                                                 ragged_grouped_lora_qkv)
    if len(pairs) == 3:
        return ragged_grouped_lora_qkv, lambda *a: ragged_grouped_lora_qkv(
            *a[:1], *a[1], *a[2:])
    return ragged_grouped_lora, lambda x, p, i, s: (
        ragged_grouped_lora(x, *p[0], i, s),)


def lora_plain(x, pairs, idx, act):
    from repro_torch.kernels.ragged_lora import ragged_grouped_lora_ref
    return tuple(ragged_grouped_lora_ref(x, a, b, idx, act) for a, b in pairs)


def lora_errors(got, want):
    """The largest (max |err|, that over max |plain|, largest row rel)
    over the outputs, by relative error."""
    return max((rel_err(g, w) for g, w in zip(got, want)),
               key=lambda e: e[1])


def lora_bound(x, pairs, idx, act):
    """What this call's data needs: bytes (the x rows on a used slot,
    A and B of each used slot once, the deltas written, the index
    vectors) and operations (2 r (d + out) per row on a used slot and
    pair); a used slot is an active one (> 0) that some row is on."""
    T, d = x.shape
    r = pairs[0][0].shape[-1]
    es = x.element_size()
    widths = [b.shape[-1] for _, b in pairs]
    used = (set(idx.tolist()) & set(act.tolist())) - {0}
    on = sum(int((idx == s).sum()) for s in used)
    nbytes = (on * d + sum(len(used) * (d * r + r * o) + T * o
                           for o in widths)) * es + 4 * (T + act.shape[0])
    ops = sum(on * 2 * r * (d + o) for o in widths)
    return nbytes, ops


def time_lora(timer, x, pairs, idx, act, dtype_name):
    """Event ms, profiler device ms per CUDA kernel, plain ms and bound
    of one call."""
    from repro_torch.kernels.bench import device_split
    fn, call = lora_call(pairs)
    nbytes, ops = lora_bound(x, pairs, idx, act)
    bound_ms, bound_by = bound(nbytes, ops, dtype_name)
    args = (x, *pairs, idx, act) if len(pairs) == 3 \
        else (x, *pairs[0], idx, act)
    return {"ms": timer(lambda: call(x, pairs, idx, act)),
            "device_split_ms": device_split(
                SimpleNamespace(args=args, kwargs={}), fn, timer),
            "plain_ms": timer(lambda: lora_plain(x, pairs, idx, act)),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "ops": ops, "T": x.shape[0]}


def check_lora(torch, cfgs, timer, gen):
    """The grouped LoRA delta against its plain version at every main
    path shape (T = 128; 3 resident slots, 2 active, rows on slot 0 and on
    the inactive slot 3 too; rank 32): within TOL of max |plain|, exact
    zeros on the rows of slot 0 and slot 3.  bf16 cases are also checked
    at a decode step, T = 4 with every row on slot 1 (an aLoRA
    evaluator's decode), and timed at both."""
    T, r = 128, 32
    idx = torch.tensor([0, 1, 2, 3] * (T // 4), dtype=torch.int32)
    idx = idx[torch.randperm(T, generator=gen)]
    res = {}
    for key, dtype_name, d, widths in lora_cases(cfgs):
        dtype = getattr(torch, dtype_name)
        x, pairs, ii, act = lora_inputs(torch, gen, dtype, T, d, r, widths,
                                        idx)
        _, call = lora_call(pairs)
        got = call(x, pairs, ii, act)
        want = lora_plain(x, pairs, ii, act)
        torch.cuda.synchronize()
        err, rel, row_rel = lora_errors(got, want)
        if rel > TOL[dtype_name]:
            fail(f"grouped LoRA {key} (d {d}): max|err| {err} = {rel} of "
                 f"max|plain| > {TOL[dtype_name]}")
        inactive = (ii == 0) | (ii == 3)
        if any(bool(g[inactive].float().abs().max() != 0) for g in got):
            fail(f"grouped LoRA {key}: slot 0 or an inactive slot leaked "
                 "into the delta")
        res[key] = {"d": d, "out": list(widths), "max_abs_err": err,
                    "rel_err": rel, "row_rel_err": row_rel,
                    "tol": TOL[dtype_name]}
        msg = ""
        if dtype_name == "bfloat16":
            res[key].update(time_lora(timer, x, pairs, ii, act, dtype_name))
            one = torch.ones(4, dtype=torch.int32, device="cuda")
            x4 = x[:4].contiguous()
            got4 = call(x4, pairs, one, act)
            want4 = lora_plain(x4, pairs, one, act)
            torch.cuda.synchronize()
            err4, rel4, row_rel4 = lora_errors(got4, want4)
            if rel4 > TOL[dtype_name]:
                fail(f"grouped LoRA {key} T=4: max|err| {err4} = {rel4} of "
                     f"max|plain| > {TOL[dtype_name]}")
            res[key]["decode4"] = time_lora(timer, x4, pairs, one, act,
                                            dtype_name)
            res[key]["decode4"].update(max_abs_err=err4, rel_err=rel4,
                                       row_rel_err=row_rel4)
            e, e4 = res[key], res[key]["decode4"]
            msg = "".join(
                f"; {name} kernel {t['ms']:.4f} ms (device " + ", ".join(
                    f"{k} {v:.4f}" for k, v in t["device_split_ms"].items())
                + f"), plain {t['plain_ms']:.3f} ms, bound "
                f"{t['bound_ms']:.5f} ms"
                for name, t in (("T=128", e), ("T=4", e4))) + (
                f"; T=4 max|err| {err4:.3e} (rel {rel4:.3e})")
        print(f"  grouped LoRA {key} (d {d}, out {widths}): max|err| "
              f"{err:.3e} (rel {rel:.3e}, tol {TOL[dtype_name]}; largest "
              f"row rel {row_rel:.3e}){msg}", flush=True)
        del x, pairs, got, want
    return res


def check_lora_edges(torch, cfgs, gen):
    """The fused Q/K/V entry at granite's widths against its plain
    version, float32 and bfloat16, at T = 1, 4, 37 and 128 and ranks 8
    and 256 (rows on slot 0, the active slots 1 and 2 and the inactive
    slot 3); then, at each T and type: every row inactive gives exact
    zeros, and NaN written into A[0], B[0] and slot 3's A and B changes
    no output.  Returns {case: relative error}."""
    g = cfgs["granite"]
    widths = (g.num_heads * g.head_dim, g.num_kv_heads * g.head_dim,
              g.num_kv_heads * g.head_dim)
    res = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for T in (1, 4, 37, 128):
            idx = torch.tensor([1, 2, 0, 3] * T, dtype=torch.int32)[:T]
            for r in (8, 256):
                key = f"qkv_{dtype_name}_T{T}_r{r}"
                x, pairs, ii, act = lora_inputs(torch, gen, dtype, T,
                                                g.d_model, r, widths, idx)
                _, call = lora_call(pairs)
                got = call(x, pairs, ii, act)
                want = lora_plain(x, pairs, ii, act)
                torch.cuda.synchronize()
                _, rel, _ = lora_errors(got, want)
                if rel > TOL[dtype_name]:
                    fail(f"grouped LoRA edges {key}: {rel} of max|plain| > "
                         f"{TOL[dtype_name]}")
                for a, b in pairs:
                    for slot in (0, 3):
                        a[slot] = float("nan")
                        b[slot] = float("nan")
                again = call(x, pairs, ii, act)
                dead = call(x, pairs, torch.full_like(ii, 3), act)
                torch.cuda.synchronize()
                if not all(torch.equal(u, v) for u, v in zip(again, got)):
                    fail(f"grouped LoRA edges {key}: NaN in slot 0 or the "
                         "inactive slot reached the output")
                if any(bool(o.float().abs().max() != 0) for o in dead):
                    fail(f"grouped LoRA edges {key}: rows on no active slot "
                         "are not exact zeros")
                res[key] = rel
                print(f"  grouped LoRA {key}: {rel:.3e} of max|plain| (tol "
                      f"{TOL[dtype_name]}); NaN in slots 0 and 3 and all-"
                      "inactive rows held", flush=True)
                del x, pairs, got, want, again, dead
    return res


def moe_bounds(cfg, idx, T):
    """The MoE layer's least times, in ms, on ``T`` bf16 rows routed to
    ``idx``: the bytes of the experts the routes touch (each touched
    expert's weights, the float32 router, x and the output, once each)
    at 3.35 TB/s; the bytes of every expert (what masked dense reads);
    and the masked-dense operations (every expert on every row: 2 d f per
    weight matrix, and the router's 2 d E) at 989 TFLOP/s."""
    from repro_torch.kernels.bench import BF16_PEAK, HBM_BYTES_PER_S
    m, d = cfg.moe, cfg.d_model
    mats = 3 if cfg.activation == "swiglu" else 2
    expert = mats * d * m.d_ff * 2
    touched = len(set(idx.flatten().tolist()))
    rest = 4 * d * m.num_experts + 2 * 2 * T * d
    ops = m.num_experts * T * mats * 2 * d * m.d_ff + 2 * T * d * m.num_experts
    return {"experts_touched": touched, "expert_bytes": expert,
            "bound_touched_bytes_ms": (touched * expert + rest)
            / HBM_BYTES_PER_S * 1e3,
            "bound_all_bytes_ms": (m.num_experts * expert + rest)
            / HBM_BYTES_PER_S * 1e3,
            "bound_ops_ms": ops / BF16_PEAK * 1e3}


def check_moe(torch, cfgs, timer):
    """The MoE layer on the card (``moe_masked_dense``: one batched
    product per weight over the expert axis, one reduction over E)
    against its plain version that adds the experts' outputs one after
    another in bf16, as the reference's scan does; bf16 at granite-moe's
    and phi3.5-moe's full widths, T = 128 and T = 4, one layer of random
    weights and N(0, 1) rows (the post-norm scale).  Within 2e-2 of max
    |plain| (the two round the sum over E differently); the routes are
    shared.  Times: the layer, its device ms and the plain version, beside
    :func:`moe_bounds`."""
    from repro_torch.kernels.bench import call_device_ms
    from repro_torch.models.moe import (init_moe, moe_masked_dense,
                                        moe_masked_dense_ref, route)
    res = {}
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name in ("granitemoe", "phimoe"):
        cfg = cfgs[name]
        p = init_moe(gen, cfg, torch.bfloat16, "cuda")
        for T in (128, 4):
            key = f"{name}_T{T}"
            x = torch.randn((T, cfg.d_model), generator=gen,
                            device="cuda").to(torch.bfloat16)
            got, _ = moe_masked_dense(p, cfg, x)
            want = moe_masked_dense_ref(p, cfg, x)
            torch.cuda.synchronize()
            err, rel, row_rel = rel_err(got, want)
            if rel > TOL["bfloat16"]:
                fail(f"MoE layer {key}: max|err| {err} = {rel} of max|plain| "
                     f"> {TOL['bfloat16']}")
            r = {"T": T, "E": cfg.moe.num_experts,
                 "k": cfg.moe.experts_per_token, "d": cfg.d_model,
                 "f": cfg.moe.d_ff, "max_abs_err": err, "rel_err": rel,
                 "row_rel_err": row_rel, "tol": TOL["bfloat16"],
                 **moe_bounds(cfg, route(p, cfg, x)[1], T),
                 "ms": timer(lambda: moe_masked_dense(p, cfg, x)),
                 "device_ms": call_device_ms(
                     lambda: moe_masked_dense(p, cfg, x), timer),
                 "plain_ms": timer(lambda: moe_masked_dense_ref(p, cfg, x),
                                   n=5, warmup=1)}
            res[key] = r
            print(f"  MoE layer {cfg.name} bf16 T={T} (E {r['E']}, top "
                  f"{r['k']}, d {r['d']}, f {r['f']}): max|err| {err:.3e} "
                  f"(rel {rel:.3e}, tol {TOL['bfloat16']}); {r['ms']:.4f} ms "
                  f"(device {r['device_ms']:.4f}), sequential plain "
                  f"{r['plain_ms']:.3f} ms; {r['experts_touched']} experts "
                  f"touched: bound {r['bound_touched_bytes_ms']:.4f} ms "
                  f"(their bytes), {r['bound_all_bytes_ms']:.4f} (every "
                  f"expert's bytes), {r['bound_ops_ms']:.4f} (masked-dense "
                  "operations)", flush=True)
            del x, got, want
        del p
        torch.cuda.empty_cache()
    return res


MIXED_SEGS = [(t, 1, t) for t in range(6)] + [(6, 64, 6), (70, 48, 7)]


def scan_inputs(torch, H, N, P, gen, T=128, segs=MIXED_SEGS, S=9):
    """A batch of the SSM layers: segments (first token, length, run
    slot) and, past them, padded rows on the dump slot (S - 1), each a
    segment start.  The default is a main-path mixed step at T = 128: 6
    decode singletons (each a segment start reading its run slot's
    state), a 64-row prefill chunk continuing a request from its live
    state, a 48-row first chunk and 10 padded rows.  Random finite entry
    states, dA <= 0.  The kept rows are the runner's: each request's last
    token, then the 16-token block boundaries inside the chunks, each
    list padded with row 0 to a power of two (at least one row)."""
    starts = torch.zeros(T, dtype=torch.int32)
    slots = torch.full((T,), S - 1, dtype=torch.int32)
    for t0, n, slot in segs:
        starts[t0] = 1
        slots[t0:t0 + n] = slot
    starts[sum(n for _, n, _ in segs):] = 1
    dt = torch.rand((T, H), generator=gen) * 0.1
    dA = -dt * torch.rand((H,), generator=gen)[None] * 8
    x = torch.randn((T, H, P), generator=gen)
    B = torch.randn((T, H, N), generator=gen)
    C = torch.randn((T, H, N), generator=gen)
    init = torch.randn((S, H, N, P), generator=gen)
    pow2 = lambda n: 1 << max(n - 1, 0).bit_length()  # noqa: E731
    last = [t0 + n - 1 for t0, n, _ in segs]
    snaps = [t for t0, n, _ in segs if n > 1 for t in range(t0, t0 + n)
             if (t - t0) % 16 == 15]
    out_rows = torch.tensor(
        last + [0] * (pow2(len(last)) - len(last))
        + snaps + [0] * (pow2(len(snaps)) - len(snaps)), dtype=torch.int32)
    return tuple(a.to("cuda") for a in (x, B, C, dA, dt, starts, slots,
                                         init, out_rows))


def check_scan_case(torch, args, label):
    """The kernel against its plain version on ``args``: y within 1e-4 of
    each token row's max |plain|, the kept states within 1e-4 of each
    (row, head)'s; returns the outputs and the errors."""
    from repro_torch.kernels.ssd_chunk import (ragged_ssd_chunk_scan,
                                               ragged_ssd_scan_ref)
    y, st = ragged_ssd_chunk_scan(*args)
    yr, sr = ragged_ssd_scan_ref(*args[:8])
    sr = sr[args[8].long()]
    torch.cuda.synchronize()
    T, H = y.shape[:2]
    M = st.shape[0]
    err_y, _, row_y = rel_err(y, yr)
    err_s, _, row_s = rel_err(st.reshape(M * H, -1), sr.reshape(M * H, -1))
    tol = TOL["float32"]
    if row_y > tol or row_s > tol:
        fail(f"ragged_ssd_chunk_scan {label}: y max|err| {err_y} ({row_y} "
             f"of a row's max|plain|), states {err_s} ({row_s}) > {tol}")
    return y, st, err_y, row_y, err_s, row_s


def time_scan(torch, timer, args, n_plain=5):
    """Event ms, profiler device ms, plain ms and bound of one call.
    Bytes: every input once (the entry rows the segment starts read), y
    and the kept states written once; four float32 operations per (token,
    head, n, p)."""
    from repro_torch.kernels.bench import device_split
    from repro_torch.kernels.ssd_chunk import (ragged_ssd_chunk_scan,
                                               ragged_ssd_scan_ref)
    x, B, C, dA, dt, starts, slots, init, out_rows = args
    T, H, P = x.shape
    N = B.shape[-1]
    M = out_rows.shape[0]
    n_init = len({int(slots[t]) for t in range(T) if int(starts[t])})
    nbytes = 4 * (T * H * P + 2 * T * H * N + 2 * T * H + 2 * T + M
                  + n_init * H * N * P + T * H * P + M * H * N * P)
    ops = 4 * T * H * N * P
    bound_ms, bound_by = bound(nbytes, ops, "float32")
    return {"ms": timer(lambda: ragged_ssd_chunk_scan(*args)),
            "device_split_ms": device_split(
                SimpleNamespace(args=args, kwargs={}), ragged_ssd_chunk_scan,
                timer),
            "plain_ms": timer(lambda: ragged_ssd_scan_ref(*args[:8]),
                              n=n_plain, warmup=1),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "ops": ops, "T": T, "kept_rows": M}


def check_ssd_scan(torch, timer, gen):
    """The ragged SSD scan against its plain version at mamba2's (H 80,
    N 128, P 64) and zamba2's (N 64) widths on the T = 128 batch, timed
    there and at a decode step (T = 4, four segment starts, each row
    kept).  Both are float32 and differ only in the order of the sums."""
    res = {}
    for arch, N in (("mamba2", 128), ("zamba2", 64)):
        H, P = 80, 64
        args = scan_inputs(torch, H, N, P, gen)
        _, _, err_y, row_y, err_s, row_s = check_scan_case(
            torch, args, f"{arch} T=128")
        res[arch] = {"N": N, "max_abs_err": max(err_y, err_s),
                     "max_abs_err_y": err_y, "max_abs_err_states": err_s,
                     "row_rel_err_y": row_y, "row_rel_err_states": row_s,
                     "tol": TOL["float32"]}
        res[arch].update(time_scan(torch, timer, args))
        # a decode step: four requests, each a segment start, each kept
        dec = scan_inputs(torch, H, N, P, gen, T=4,
                          segs=[(t, 1, t) for t in range(4)])
        check_scan_case(torch, dec, f"{arch} T=4")
        res[arch]["decode4"] = time_scan(torch, timer, dec)
        e, e4 = res[arch], res[arch]["decode4"]
        print(f"  ragged_ssd_chunk_scan float32 {arch} (H {H}, N {N}, P {P}, "
              f"T 128, {e['kept_rows']} kept rows): y max|err| {err_y:.3e} "
              f"(row rel {row_y:.3e}), states {err_s:.3e} (row rel "
              f"{row_s:.3e}), tol {TOL['float32']}", flush=True)
        for name, t in (("T=128", e), ("T=4", e4)):
            print(f"    {name}: kernel {t['ms']:.4f} ms (device "
                  + ", ".join(f"{k} {v:.4f}" for k, v in
                              t["device_split_ms"].items())
                  + f"), plain {t['plain_ms']:.3f} ms, bound "
                  f"{t['bound_ms']:.4f} ms ({t['bound_by']})", flush=True)
        del args, dec
    return res


def check_scan_edges(torch, gen):
    """The ragged scan's kept rows and entry reads at zamba2's widths (N
    64) and the reduced models' (N 16, P 32): ``out_rows`` unsorted, with
    repeats and with block-boundary rows inside a segment, against the
    plain version; then NaN written into every ``init_states`` row that no
    segment start names changes no output, and ``out_rows`` entries -1
    and T give zero rows.  Returns {case: relative error of the
    states}."""
    res = {}
    for label, (H, N, P) in (("N64", (80, 64, 64)), ("N16", (8, 16, 32))):
        args = scan_inputs(torch, H, N, P, gen, T=77,
                           segs=MIXED_SEGS[:7] + [(70, 7, 7)])
        x, B, C, dA, dt, starts, slots, init, _ = args
        # unsorted, repeats, boundaries mid-segment
        rows = torch.tensor([76, 5, 0, 0, 21, 69, 6, 37, 37, 53, 5],
                            dtype=torch.int32, device="cuda")
        args = (x, B, C, dA, dt, starts, slots, init, rows)
        y, st, _, _, _, row_s = check_scan_case(torch, args,
                                                f"edges {label}")
        read = {int(slots[t]) for t in range(x.shape[0]) if int(starts[t])}
        for s_ in range(init.shape[0]):
            if s_ not in read:
                init[s_] = float("nan")
        from repro_torch.kernels.ssd_chunk import ragged_ssd_chunk_scan
        y2, st2 = ragged_ssd_chunk_scan(*args)
        torch.cuda.synchronize()
        if not (torch.equal(y2, y) and torch.equal(st2, st)):
            fail(f"ragged_ssd_chunk_scan edges {label}: NaN in an unread "
                 "init_states row reached the output")
        # entries outside [0, T) name no token: their rows are zeros
        bad = torch.tensor([-1, x.shape[0]], dtype=torch.int32,
                           device="cuda")
        y3, st3 = ragged_ssd_chunk_scan(*args[:8], torch.cat([rows, bad]))
        torch.cuda.synchronize()
        if not (torch.equal(y3, y) and torch.equal(st3[:len(rows)], st)
                and not bool(st3[len(rows):].abs().max() != 0)):
            fail(f"ragged_ssd_chunk_scan edges {label}: out_rows entries "
                 "-1 and T did not give zero rows beside the kept ones")
        res[label] = row_s
        print(f"  ragged_ssd_chunk_scan edges {label} (T 77, kept rows "
              f"{rows.tolist()}): states {row_s:.3e} of a row's max|plain|;"
              " NaN in the unread init rows held; rows -1 and T zeros",
              flush=True)
        del args, y, st, y2, st2, y3, st3
    return res


def alora_edge_args(torch, gen, dtype, T, d, out, r):
    """The fused projection with five stacked adapters at an edge shape:
    rows on adapters 0..3 and on the indices -1 and 5, none on adapter 4.
    Returns (args, the same with NaN in A[0], B[0], A[4] and B[4])."""
    from repro_torch.kernels import bench
    case = bench.alora_case(gen, "cuda", dtype, T=T, d=d, out=out, n=5, r=r,
                            name="edge", edge=True)
    x, w, a, b, idx = case.args
    idx = torch.where(idx == 4, torch.ones_like(idx), idx).contiguous()
    an, bn = a.clone(), b.clone()
    for i in (0, 4):
        an[i] = float("nan")
        bn[i] = float("nan")
    return (x, w, a, b, idx), (x, w, an, bn, idx)


def check_bench_edges(torch):
    """Decode attention, the fused aLoRA QKV projection and the dense SSD
    scan against their plain versions at small shapes that reach every
    masked edge, in float32 and bf16 (the scan float32 only): lengths 5,
    17 and 40 over 16-token blocks, with no window and a 7-token one, and
    lengths 255, 256, 257 and 560 around the kernel's 256-token split
    boundary, with no window and a 24-token one; the projection at T 1,
    100, 130 and 300 (64- and 128-row tiles, d split at T <= 128 and
    whole-d tiles above), d 264 (off the 32/64-column k steps), out 200
    and 6144 (off the 128/192-column tiles), ranks 8 and 32, with NaN in
    A[0], B[0] and an adapter no row is on, and rows on the indices -1 and
    n: the NaN must change no output; the scan at S 70 and 130 (off its
    32- and 64-token chunks), P 40 (off its 16-column warp slices), N 32,
    64 and 128, with Bt * H = 6 (P cut into slices) and 140 (whole-P
    blocks).  Within TOL of max |plain|, of each row for attention.
    Returns {case: relative error}."""
    from repro_torch.kernels import alora_qkv, bench, ssd_chunk
    gen = torch.Generator(device="cuda").manual_seed(1)
    builders = []
    for dtype in (torch.float32, torch.bfloat16):
        for window in (0, 7):
            builders.append(lambda dtype=dtype, window=window:
                            bench.attention_case(
                                gen, "cuda", dtype, B=3, H=32, KV=8,
                                hd=128, bs=16, lengths=[5, 17, 40], nb=4,
                                window=window, name=f"edge_window{window}"))
        # contexts each side of the kernel's 256-token split boundary and
        # one ending on a block; the 24-token window straddles the
        # boundary at 257
        for window in (0, WINDOW):
            builders.append(lambda dtype=dtype, window=window:
                            bench.attention_case(
                                gen, "cuda", dtype, B=4, H=32, KV=8,
                                hd=128, bs=16, lengths=[255, 256, 257, 560],
                                nb=48, window=window,
                                name=f"split_window{window}"))
    res = {}
    for make in builders:
        case = make()
        kernel, plain = bench.WRAPPERS[case.kernel]
        dtype_name = str(case.dtype).replace("torch.", "")
        key = f"{case.kernel}/{case.name}_{dtype_name}"
        got = bench.outputs(kernel(*case.args, **case.kwargs))
        want = bench.outputs(plain(*case.args, **case.kwargs))
        torch.cuda.synchronize()
        tol = TOL[dtype_name]
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        rel = max(e[2] if case.per_row else e[1] for e in errs)
        if rel > tol:
            fail(f"{key}: {rel} of max|plain|"
                 f"{' (per row)' if case.per_row else ''} > {tol}")
        res[key] = rel
        print(f"  {key}: {rel:.3e} of max|plain|"
              f"{' per row' if case.per_row else ''} (tol {tol})",
              flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        dtype_name = str(dtype).replace("torch.", "")
        tol = TOL[dtype_name]
        for T in (1, 100, 130, 300):
            for out in (200, 6144):
                for r in (8, 32):
                    args, nan_args = alora_edge_args(torch, gen, dtype, T,
                                                     264, out, r)
                    got = alora_qkv.alora_qkv(*args)
                    again = alora_qkv.alora_qkv(*nan_args)
                    want = alora_qkv.alora_qkv_ref(*args)
                    torch.cuda.synchronize()
                    key = f"alora_qkv/edge_T{T}_out{out}_r{r}_{dtype_name}"
                    if not torch.equal(got, again):
                        fail(f"{key}: NaN in A[0], B[0] or an adapter no "
                             "row is on reached the output")
                    rel = rel_err(got, want)[1]
                    if rel > tol:
                        fail(f"{key}: {rel} of max|plain| > {tol}")
                    res[key] = rel
                    p = alora_qkv.plan(T, 264, out, r, 5, dtype)
                    print(f"  {key}: {rel:.3e} of max|plain| (tol {tol}); "
                          f"tiles {p.bm} x {p.bn}, grid {p.grid}; NaN "
                          "held", flush=True)
    for N in (32, 64, 128):
        for S in (70, 130):
            for H in (3, 70):
                case = bench.ssd_case(gen, "cuda", Bt=2, S=S, H=H, P=40, N=N,
                                      name="edge", plain_iters=1)
                got = ssd_chunk.ssd_chunk_scan(*case.args)
                want = ssd_chunk.ssd_chunk_ref(*case.args)
                torch.cuda.synchronize()
                key = f"ssd_chunk_scan/edge_S{S}_H{H}_N{N}_float32"
                rel = max(rel_err(g, w)[1] for g, w in zip(got, want))
                if rel > TOL["float32"]:
                    fail(f"{key}: {rel} of max|plain| > {TOL['float32']}")
                res[key] = rel
                p = ssd_chunk.dense_plan(2, S, H, N, 40)
                print(f"  {key}: {rel:.3e} of max|plain| (tol "
                      f"{TOL['float32']}); chunk {p.chunk}, {p.cols} "
                      f"columns a block, grid {p.grid}, {p.stages} stages",
                      flush=True)
    return res


def slot_rank_card(torch):
    """The adapter pool's slot rank on the card: a reduced granite engine
    asked for slot rank 48 holds the LoRA kernel's bucket 64 and serves
    the base -> aLoRA pipeline to the end; an engine given a rank-300
    adapter raises at construction (the kernel takes ranks up to 256)."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.alora import AdapterSpec, init_adapter_weights
    from repro_torch.models.model import init_params
    from repro_torch.serving import Engine, EngineConfig

    cfg = get_reduced("granite-3.2-8b")
    gen = torch.Generator().manual_seed(2)
    params = init_params(gen, cfg, device="cpu")
    w = init_adapter_weights(gen, cfg, 32, device="cpu")
    eng = Engine(cfg, params, device="cuda",
                 adapters=[(AdapterSpec("eval", 32, INV), w)],
                 engine_cfg=EngineConfig(adapter_slot_rank=48))
    if eng.adapter_pool.slot_rank != 64:
        fail(f"slot rank 48 on the card gave {eng.adapter_pool.slot_rank}, "
             "not the bucket 64")
    res, _ = run_pipeline(torch, eng, prompt_len=40, gen_len=12, eval_len=6,
                          batch=3, seed=3)
    lens = [len(eng.request(i).output_tokens) for i in res.base_ids] + \
        [len(eng.request(i).output_tokens) for i in res.eval_ids]
    if lens != [12] * len(res.base_ids) + [6] * len(res.eval_ids):
        fail(f"the slot-rank-64 engine did not serve to the end: {lens}")
    big = init_adapter_weights(gen, cfg, 300, device="cpu")
    try:
        Engine(cfg, params, device="cuda",
               adapters=[(AdapterSpec("big", 300, INV), big)])
    except ValueError as e:
        raised = str(e)
    else:
        fail("an engine with a rank-300 adapter was built on the card")
    print(f"  slot rank 48 -> {eng.adapter_pool.slot_rank}: "
          f"{len(lens)} requests served; rank 300 raises: {raised}",
          flush=True)
    return {"asked": 48, "slot_rank": eng.adapter_pool.slot_rank,
            "requests": len(lens), "rank_300": raised}


def check_sequential_kernels(torch, cfgs, timer):
    """Decode attention (B4) and the fused aLoRA projection (B6) at the
    sequential step's serving shapes, bf16, against their plain versions,
    timed beside their bounds and library yardsticks (SDPA over gathered
    K/V; the base GEMM alone for B6, which no one library call computes):
    granite's (GQA 32/8/128), zamba2's (MHA 32/32/80) and whisper's (MHA
    20/20/64) decode batch of 4 (contexts 257-288, the pipeline's decode
    positions, over a 32-block table) for B4, and for B6 their Q
    projections (granite 4096 -> 4096, zamba2 2560 -> 2560, whisper 1280
    -> 1280; zamba2's and whisper's K and V have the Q shape) and
    granite's K/V width (4096 -> 1024), at a decode batch of 4 and
    prefill chunks of 64 (the engine's chunk) and 128 tokens, one rank-32
    adapter slot (the engine's pool) with half the rows on it.  Returns
    {kernel/case: result}."""
    from repro_torch.kernels import bench
    gen = torch.Generator(device="cuda").manual_seed(4)
    dt = torch.bfloat16
    cases = []
    for arch in ("granite", "zamba2", "whisper"):
        c = cfgs[arch]
        cases.append(bench.attention_case(
            gen, "cuda", dt, B=4, H=c.num_heads, KV=c.num_kv_heads,
            hd=c.head_dim, bs=16, lengths=[257, 270, 281, 288], nb=32,
            window=0, name=f"{arch}_decode4"))
        widths = [("q", c.num_heads * c.head_dim)] + (
            [("kv", c.num_kv_heads * c.head_dim)] if arch == "granite"
            else [])
        for proj, out in widths:
            for T in (4, 64, 128):
                cases.append(bench.alora_case(
                    gen, "cuda", dt, T=T, d=c.d_model, out=out, n=2, r=32,
                    name=f"{arch}_{proj}_T{T}"))
    res = {}
    for case in cases:
        kernel, plain = bench.WRAPPERS[case.kernel]
        got = kernel(*case.args, **case.kwargs)
        want = plain(*case.args, **case.kwargs)
        torch.cuda.synchronize()
        r = bench.errors(got, want, case.per_row)
        rel = r["row_rel_err"] if case.per_row else r["rel_err"]
        key = f"{case.kernel}/{case.name}"
        if not r["finite"] or rel > TOL["bfloat16"]:
            fail(f"{key}: finite {r['finite']}, {rel} of max|plain| > "
                 f"{TOL['bfloat16']}")
        r.update(shape=case.shape, dtype="bfloat16", tol=TOL["bfloat16"],
                 ms=timer(lambda: kernel(*case.args, **case.kwargs)),
                 plain_ms=timer(lambda: plain(*case.args, **case.kwargs)),
                 device_split_ms=bench.device_split(case, kernel, timer))
        r["bound_ms"], r["bound_by"] = bench.bound_ms(case.nbytes, case.ops,
                                                      dt)
        name, factory = case.yardstick
        r[name] = timer(factory())
        r.setdefault("library_ms", None)
        if case.kernel == "alora_qkv":
            r["device_span_ms"] = bench.device_span(case, kernel, timer)
        res[key] = r
        print(f"  {key} ({case.shape}): {rel:.3e} of max|plain| (tol "
              f"{TOL['bfloat16']}); kernel {r['ms']:.4f} ms (device "
              + ", ".join(f"{k} {v:.4f}" for k, v in
                          r["device_split_ms"].items())
              + f"), plain {r['plain_ms']:.3f} ms, {name} {r[name]:.4f} "
              f"ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})",
              flush=True)
        del got, want
    return res


# ---------------------------------------------------------------------------
# phases 3 and 4: the engine
# ---------------------------------------------------------------------------
def counted():
    """Every kernel wrapper of the port, by name."""
    from repro_torch.kernels import (alora_qkv, paged_attention, ragged_lora,
                                     ssd_chunk)
    return {"ragged_paged_attention": paged_attention.ragged_paged_attention,
            "ragged_grouped_lora": ragged_lora.ragged_grouped_lora,
            "ragged_grouped_lora_qkv": ragged_lora.ragged_grouped_lora_qkv,
            "ragged_ssd_chunk_scan": ssd_chunk.ragged_ssd_chunk_scan,
            "paged_attention": paged_attention.paged_attention,
            "ssd_chunk_scan": ssd_chunk.ssd_chunk_scan,
            "alora_qkv": alora_qkv.alora_qkv}


def reset_counts():
    for fn in counted().values():
        fn.launches = 0


SERVING = ("ragged_paged_attention", "ragged_grouped_lora",
           "ragged_grouped_lora_qkv", "ragged_ssd_chunk_scan")


def read_counts():
    """Launches since ``reset_counts`` of the serving kernels' wrappers,
    in ``SERVING`` order."""
    c = counted()
    return tuple(c[k].launches for k in SERVING)


def vision_traffic(eng, *, adapter_names, prompt_len, gen_len, eval_len,
                   batch, seed):
    """The base → adapter pipeline on images: each of ``batch`` prompts is
    ``num_patches`` pseudo-tokens under its own image's patch embeddings
    (N(0, 0.02) from ``seed``, salted with their digest), then
    ``prompt_len`` text tokens; each adapter's eval request is x + y +
    its invocation tokens on the same image.  Then one base request with
    prompt 0's tokens under another image (``other_ids``), which may
    reuse none of the first image's blocks.  Returns the request ids as
    ``pipelines.base_adapter`` does, the other request among the base
    ones."""
    import hashlib
    rng = np.random.RandomState(seed)
    cfg = eng.cfg
    pseudo = [IMAGE_TOKEN] * cfg.num_patches
    images = []
    for _ in range(batch + 1):
        pe = (rng.randn(cfg.num_patches, cfg.d_model) * 0.02).astype(
            np.float32)
        images.append((pe, (hashlib.sha256(pe.tobytes()).hexdigest(),)))
    prompts = [pseudo + list(rng.randint(10, cfg.vocab_size, prompt_len))
               for _ in range(batch)]
    res = SimpleNamespace(base_ids=[], eval_ids=[], other_ids=[])
    for x, (pe, salt) in zip(prompts, images):
        res.base_ids.append(eng.submit(x, gen_len, prefix_embeds=pe,
                                       salt=salt))
    eng.run_until_idle()
    for rid, x, (pe, salt) in zip(list(res.base_ids), prompts, images):
        y = eng.request(rid).output_tokens
        for name in adapter_names:
            inv = list(eng.adapters[name].spec.invocation_tokens or ())
            res.eval_ids.append(eng.submit(x + y + inv, eval_len,
                                           adapter_name=name,
                                           prefix_embeds=pe, salt=salt))
    eng.run_until_idle()
    pe, salt = images[-1]
    res.other_ids.append(eng.submit(prompts[0], gen_len, prefix_embeds=pe,
                                    salt=salt))
    res.base_ids += res.other_ids
    eng.run_until_idle()
    return res


def audio(rng, cfg):
    """One request's (Se, d) frame embeddings, N(0, 0.02) from ``rng``,
    as ``submit`` keywords with their digest as the cache salt."""
    import hashlib
    fr = (rng.randn(cfg.encoder_seq_len, cfg.d_model) * 0.02).astype(
        np.float32)
    return dict(frame_embeds=fr,
                salt=(hashlib.sha256(fr.tobytes()).hexdigest(),))


def audio_traffic(eng, *, adapter_names, prompt_len, gen_len, eval_len,
                  batch, seed):
    """The base → adapter pipeline on audio: each of ``batch`` prompts of
    ``prompt_len`` tokens on its own audio's frames (salted with their
    digest), each adapter's eval request x + y + its invocation tokens on
    the same audio; then one base request with prompt 0 on another audio
    (``other_ids``), which may reuse none of the first audio's blocks.
    Returns the request ids as ``pipelines.base_adapter`` does, the other
    request among the base ones."""
    rng = np.random.RandomState(seed)
    cfg = eng.cfg
    auds = [audio(rng, cfg) for _ in range(batch + 1)]
    prompts = [list(rng.randint(10, cfg.vocab_size, prompt_len))
               for _ in range(batch)]
    res = SimpleNamespace(base_ids=[], eval_ids=[], other_ids=[])
    for x, a in zip(prompts, auds):
        res.base_ids.append(eng.submit(x, gen_len, **a))
    eng.run_until_idle()
    for rid, x, a in zip(list(res.base_ids), prompts, auds):
        y = eng.request(rid).output_tokens
        for name in adapter_names:
            inv = list(eng.adapters[name].spec.invocation_tokens or ())
            res.eval_ids.append(eng.submit(x + y + inv, eval_len,
                                           adapter_name=name, **a))
    eng.run_until_idle()
    res.other_ids.append(eng.submit(prompts[0], gen_len, **auds[-1]))
    res.base_ids += res.other_ids
    eng.run_until_idle()
    return res


def run_pipeline(torch, eng, adapter_names=("eval",), **kw):
    """The base → adapter pipeline on ``eng`` (on images for a vision
    model, on audio for an encoder-decoder), each engine step timed by
    the host clock."""
    from repro_torch.serving import pipelines
    step_ms = []
    orig = eng.step

    def timed_step():
        t0 = time.perf_counter()
        out = orig()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    eng.step = timed_step
    traffic = {"vision": vision_traffic, "audio": audio_traffic}.get(
        eng.cfg.frontend, pipelines.base_adapter)
    res = traffic(eng, adapter_names=list(adapter_names), **kw)
    if eng.runner.device.type == "cuda":
        torch.cuda.synchronize()
    return res, step_ms


# the paper's base -> aLoRA traffic of every main path, and starcoder2's
# second run with a prompt past its 4096-token window
PIPE = dict(prompt_len=256, gen_len=32, eval_len=8, batch=4, seed=0)
LONG_PIPE = dict(prompt_len=4608, gen_len=16, eval_len=8, batch=1, seed=0)


def main_path(torch, arch: str, profile: bool, long: bool = False,
              num_layers: int = 0, sequential: bool = False):
    """Serve ``arch`` at full width (random weights from a seed, one
    rank-32 aLoRA adapter; ``num_layers`` of its layers where given)
    through the base → aLoRA pipeline (``PIPE``; on images of its
    ``num_patches`` patches for a vision model) and hold the launch
    counts, the reuse (≥ 256 tokens, plus the patches) and the drained
    pools to what the path must give; with ``long``, then serve
    ``LONG_PIPE`` on the same engine (every eval request reusing ≥ 4,096
    tokens); with ``profile``, then time a decode window; with
    ``sequential``, then serve ``PIPE`` again on the same weights through
    ``execution_mode="sequential"`` (:func:`serve_sequential`)."""
    from repro_torch.common import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.core.alora import AdapterSpec, init_adapter_weights
    from repro_torch.models.model import init_params
    from repro_torch.serving import Engine

    cfg = get_config(arch)
    if num_layers:
        cfg = cfg.replace(num_layers=num_layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(gen, cfg, device="cuda")
    adapter = init_adapter_weights(gen, cfg, 32, device="cuda")
    eng = Engine(cfg, params, device="cuda",
                 adapters=[(AdapterSpec("eval", 32, INV), adapter)])
    torch.cuda.synchronize()
    weights_gb = sum(t.numel() * t.element_size() for t in
                     tree_leaves(params)) / 1e9
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    print(f"  {cfg.name} ({cfg.num_layers} layers): "
          f"{cfg.param_count() / 1e9:.2f} B parameters ({weights_gb:.2f} GB"
          f"), {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card of "
          f"{card_gb:.2f}, set-up {time.perf_counter() - t0:.1f} s",
          flush=True)
    summary = serve_pipeline(torch, eng, cfg, PIPE,
                             min_hits=256 + cfg.num_patches)
    summary.update(arch=arch, weights_gb=weights_gb, num_layers=cfg.num_layers,
                   params=cfg.param_count(),
                   active_params=cfg.active_param_count(),
                   memory_gb=torch.cuda.memory_allocated() / 1e9,
                   card_memory_gb=card_gb, window=cfg.sliding_window)
    if long:
        print(f"  {cfg.name} again with {LONG_PIPE}", flush=True)
        summary["long"] = serve_pipeline(torch, eng, cfg, LONG_PIPE,
                                         min_hits=4096)
        summary["long"].pop("outputs")
    if arch == "granite-3.2-8b":
        # the per-step host-embedding upload the assembly mirrors from
        # the reference: a (128, d) float32 pinned buffer, non_blocking
        host = torch.empty((128, cfg.d_model), dtype=torch.float32,
                           pin_memory=True)
        from repro_torch.kernels.bench import Timer
        up = Timer("cuda")(lambda: host.to("cuda", non_blocking=True))
        print(f"  host-embed upload (128 x {cfg.d_model} fp32): {up:.4f} ms",
              flush=True)
        summary["host_embed_upload_ms"] = up
    if profile:
        dp = summary["decode_profile"] = profile_decode(torch, eng, cfg)
        # the least time a decode step could take: every weight read
        # once at the HBM rate
        dp["weight_read_bound_ms"] = bound(weights_gb * 1e9, 0,
                                           "bfloat16")[0]
        if cfg.is_encoder_decoder:
            # a decode step reads no encoder weight and no cross K/V
            # projection; it reads the 4 requests' encoder K/V, whose
            # values are in the model dtype (the pools hold them in
            # float32: ``xkv_pool_gb``)
            skip = {id(t) for t in tree_leaves(params["encoder"])} | {
                id(lp["xattn"][k]) for lp in params["layers"]
                for k in ("wk", "wv")}
            step_bytes = sum(t.numel() * t.element_size()
                             for t in tree_leaves(params)
                             if id(t) not in skip)
            elems = 4 * cfg.num_layers * 2 * cfg.num_kv_heads \
                * cfg.encoder_seq_len * cfg.head_dim
            xkv = elems * params["final_norm"].element_size()
            dp["decode_read_bound_ms"] = bound(step_bytes + xkv, 0,
                                               "bfloat16")[0]
            dp["decode_read_gb"] = (step_bytes + xkv) / 1e9
            dp["xkv_gb"] = xkv / 1e9
            dp["xkv_pool_gb"] = elems * eng.runner.xk_pool.element_size() \
                / 1e9
            busy = dp["device_busy_ms"] or float("nan")
            print(f"  decode read bound: {dp['decode_read_bound_ms']:.3f} ms "
                  f"({step_bytes / 1e9:.2f} GB of decoder weights, "
                  f"{xkv / 1e9:.2f} GB of the 4 requests' encoder K/V in "
                  f"the model dtype; the pools hold them in "
                  f"{dp['xkv_pool_gb']:.2f} GB); busy / bound "
                  f"{busy / dp['decode_read_bound_ms']:.2f}",
                  flush=True)
            dp["cross_layouts"] = cross_layouts(torch, eng, cfg)
        if cfg.moe is not None:
            # masked dense reads every expert; the routes need only the
            # experts they touch, with every other weight
            m = cfg.moe
            expert = (3 if cfg.activation == "swiglu" else 2) \
                * cfg.d_model * m.d_ff * 2
            rest = weights_gb * 1e9 - cfg.num_layers * m.num_experts * expert
            dp["routed_bound_ms"] = bound(
                rest + dp["experts_touched_per_step"] * expert, 0,
                "bfloat16")[0]
            dp["expert_gb_per_step"] = cfg.num_layers * m.num_experts \
                * expert / 1e9
            dp["routed_expert_gb_per_step"] = \
                dp["experts_touched_per_step"] * expert / 1e9
            print(f"  decode bounds: weight read "
                  f"{dp['weight_read_bound_ms']:.3f} ms (every expert, "
                  f"{dp['expert_gb_per_step']:.2f} GB of "
                  f"them), routed {dp['routed_bound_ms']:.3f} ms "
                  f"({dp['experts_touched_per_step']:.1f} of "
                  f"{cfg.num_layers * m.num_experts} layer-experts touched, "
                  f"{dp['routed_expert_gb_per_step']:.2f} GB)", flush=True)
    outputs = summary.pop("outputs")
    # the timed step wrapper refers back to the engine: collect the cycle
    # so the next model finds the card empty
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if sequential:
        from repro_torch.serving import EngineConfig
        eng = Engine(cfg, params, device="cuda",
                     adapters=[(AdapterSpec("eval", 32, INV), adapter)],
                     engine_cfg=EngineConfig(execution_mode="sequential"))
        summary["sequential"] = serve_sequential(torch, eng, cfg, PIPE,
                                                 summary, outputs)
        del eng
    del params, adapter
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def serve_pipeline(torch, eng, cfg, pipe, min_hits):
    """One ``pipelines.base_adapter`` run on ``eng`` with every kernel
    count set to 0 just before and read just after: each request's
    tokens, every eval request reusing ≥ ``min_hits`` prompt tokens (and
    restoring a state snapshot on SSM stacks), one fused Q/K/V call and
    one attention call per attention layer and mixed step, one
    in-projection call and one scan per SSM layer and step, and the pools
    drained.  Returns the run's summary."""
    from repro_torch.configs import SSM
    from repro_torch.models.layers import padded_vocab
    torch.cuda.reset_peak_memory_stats()
    steps0 = eng.runner.call_counts["mixed_step"]
    # the shape of every mixed step: packed tokens, adapted tokens, active
    # adapter slots (which B2 launches at which shapes)
    shapes = []
    submit = eng.runner.submit_batch

    def recorded(mb):
        shapes.append((len(mb.adapter_idx), int((mb.adapter_idx > 0).sum()),
                       0 if mb.active_slots is None
                       else len(mb.active_slots)))
        return submit(mb)

    eng.runner.submit_batch = recorded
    reset_counts()
    res, step_ms = run_pipeline(torch, eng, **pipe)
    counts = dict(zip(SERVING, read_counts()))
    eng.runner.submit_batch = submit
    steps = eng.runner.call_counts["mixed_step"] - steps0
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
    print("  launches: " + ", ".join(f"{k} {v}" for k, v in counts.items()),
          flush=True)
    other = [eng.request(i).n_cache_hit_tokens
             for i in getattr(res, "other_ids", ())]
    if other:
        print(f"  another {cfg.frontend} under the same tokens: "
              f"n_cache_hit_tokens {other}", flush=True)
    adapted = [(T, n) for T, n, _ in shapes if n]
    share = {"steps": len(shapes), "steps_with_adapted_tokens":
             len(adapted), "tokens": sum(T for T, _, _ in shapes),
             "adapted_tokens": sum(n for _, n in adapted),
             "T_of_adapted_steps": sorted({T for T, _ in adapted}),
             "adapted_per_adapted_step": [n for _, n in adapted]}
    print(f"  adapted tokens: {share['adapted_tokens']} of "
          f"{share['tokens']} in {share['steps_with_adapted_tokens']} of "
          f"{share['steps']} steps; T of those steps "
          f"{share['T_of_adapted_steps']}", flush=True)
    vpad = padded_vocab(cfg)
    for rid, o in zip(ids, outs):
        want = pipe["gen_len"] if rid in res.base_ids else pipe["eval_len"]
        if len(o) != want or not all(0 <= t < vpad for t in o):
            fail(f"request {rid}: tokens {o} are not {want} ids < {vpad}")
    if min(hits) < min_hits:
        fail(f"an eval request reused fewer than {min_hits} tokens: {hits}")
    if any(other):
        fail(f"a request on another {cfg.frontend} reused {other} tokens")
    Ls = cfg.pattern().count(SSM)
    La = cfg.num_layers - Ls
    if Ls and not all(reused):
        fail(f"an eval request did not restore a state snapshot: {reused}")
    # one fused Q/K/V call per attention layer, one in-projection call
    # per SSM layer
    want = dict(zip(SERVING, (La * steps, Ls * steps, La * steps,
                              Ls * steps)))
    if counts != want:
        fail(f"launch counts {counts} != {want} for {steps} mixed steps of "
             f"{La} attention and {Ls} SSM layers")
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
    encodes = None
    if cfg.is_encoder_decoder:
        # written once per admission into the request's run slot, read in
        # place by every step
        encodes = eng.runner.call_counts["encode"]
        per = 2 * La * cfg.num_kv_heads * cfg.encoder_seq_len \
            * cfg.head_dim * 4
        print(f"  encoder: {encodes} encode calls (one per admission), "
              f"{per / 1e6:.1f} MB of float32 K/V written per call, 0 "
              f"encoder K/V copies per step; pools "
              f"{eng.runner.xk_pool.numel() * 8 / 1e9:.2f} GB", flush=True)
    phases = {}
    for kind, track, _, t0_, t1_, _, _ in eng.tracer.events:
        if kind == "span":
            phases.setdefault(track, []).append((t1_ - t0_) * 1e3)
    phase_ms = {k: statistics.mean(v) for k, v in phases.items()}
    print("  mean host ms per phase: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phase_ms.items()), flush=True)
    return {"pipeline": pipe, "steps": steps, "other_image_hits": other,
            "outputs": outs, "encode_calls": encodes,
            "step_ms_mean": statistics.mean(step_ms),
            "step_ms_median": statistics.median(step_ms),
            "tokens_emitted": emitted, "eval_cache_hits": hits,
            "eval_state_reused": reused,
            "max_position": max(len(eng.request(i).prompt)
                                + len(eng.request(i).output_tokens)
                                for i in ids),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts,
            "launches_per_step": {k: v / steps for k, v in counts.items()},
            "adapted": share, "phase_ms": phase_ms}


def top2_margin(torch, logits) -> float:
    """The smallest top-1 minus top-2 logit over the rows of ``logits``
    (a greedy token flips only where this is near the rounding)."""
    t = torch.as_tensor(logits).float()
    top = torch.topk(t.reshape(-1, t.shape[-1]), 2, dim=-1).values
    return float((top[:, 0] - top[:, 1]).min())


@contextlib.contextmanager
def sequential_calls(torch, eng):
    """Record each sequential device call of ``eng`` while the block
    runs: its kind ("prefill_chunk" or "decode_batch"), its wall ms (the
    call and the wait for its logits, as the engine waits) and its
    logits' smallest top-1/top-2 margin."""
    runner = eng.runner
    calls = []

    def wrap(name):
        orig = getattr(runner, name)

        def call(**kw):
            t0 = time.perf_counter()
            out = orig(**kw)
            logits = out[0] if name == "prefill_chunk" else out
            margin = top2_margin(torch, logits)
            calls.append((name, (time.perf_counter() - t0) * 1e3, margin))
            return out
        return orig, call

    saved = {}
    for name in ("prefill_chunk", "decode_batch"):
        saved[name], fn = wrap(name)
        setattr(runner, name, fn)
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(runner, name, fn)


SEQ_KERNELS = ("paged_attention", "alora_qkv", "ragged_grouped_lora",
               "ragged_paged_attention", "ragged_grouped_lora_qkv",
               "ragged_ssd_chunk_scan")


def serve_sequential(torch, eng, cfg, pipe, mixed, mixed_outputs):
    """``pipe`` through the sequential execution mode (one device call per
    decode batch and per prefill chunk), every kernel count set to 0 just
    before and read just after: per call of either kind, one decode
    attention (B4) per attention layer of a decode call, one fused aLoRA
    projection (B6) per Q/K/V projection of an attention layer, one
    grouped-delta call (B2, every slot active) per SSM layer, and no
    launch of the mixed step's kernels; each eval reusing as many tokens
    as in the mixed run ``mixed``.  Prints the wall ms per call, the
    launches per call, and how many generated tokens agree with the mixed
    run's (bf16: no limit on that count).  Returns the run's summary."""
    from repro_torch.configs import SSM
    c = counted()
    for fn in c.values():
        fn.launches = 0
    with sequential_calls(torch, eng) as calls:
        res, step_ms = run_pipeline(torch, eng, **pipe)
    counts = {k: c[k].launches for k in SEQ_KERNELS}
    n_pre = sum(1 for k, _, _ in calls if k == "prefill_chunk")
    n_dec = len(calls) - n_pre
    Ls = cfg.pattern().count(SSM)
    La = cfg.num_layers - Ls
    want = {"paged_attention": La * n_dec,
            "alora_qkv": 3 * La * (n_pre + n_dec),
            "ragged_grouped_lora": Ls * (n_pre + n_dec),
            "ragged_paged_attention": 0, "ragged_grouped_lora_qkv": 0,
            "ragged_ssd_chunk_scan": 0}
    if counts != want:
        fail(f"{cfg.name} sequential: launch counts {counts} != {want} for "
             f"{n_pre} prefill and {n_dec} decode calls of {La} attention "
             f"and {Ls} SSM layers")
    if n_dec == 0 or (La and not counts["paged_attention"]):
        fail(f"{cfg.name} sequential: no decode attention launched")
    ids = res.base_ids + res.eval_ids
    outs = [eng.request(i).output_tokens for i in ids]
    hits = [eng.request(i).n_cache_hit_tokens for i in res.eval_ids]
    if hits != mixed["eval_cache_hits"]:
        fail(f"{cfg.name} sequential: eval reuse {hits} != the mixed run's "
             f"{mixed['eval_cache_hits']}")
    other = [eng.request(i).n_cache_hit_tokens
             for i in getattr(res, "other_ids", ())]
    if any(other):
        fail(f"{cfg.name} sequential: another {cfg.frontend} reused "
             f"{other} tokens")
    if Ls and not all(eng.request(i).state_reused for i in res.eval_ids):
        fail(f"{cfg.name} sequential: an eval did not restore a snapshot")
    agree = sum(a == b for o, m in zip(outs, mixed_outputs)
                for a, b in zip(o, m))
    total = sum(len(o) for o in outs)
    ms = {k: [t for n, t, _ in calls if n == k]
          for k in ("prefill_chunk", "decode_batch")}
    per_call = {k: {"calls": len(v), "wall_ms_mean": statistics.mean(v),
                    "wall_ms_median": statistics.median(v)}
                for k, v in ms.items() if v}
    margin = min(m for _, _, m in calls)
    for mgr in (eng.kv_mgr, eng.st_mgr):
        if mgr is not None and (mgr.num_free() != mgr.num_blocks
                                or any(m.ref for m in mgr.meta)):
            fail(f"{cfg.name} sequential: a pool leaked after the drain")
    print(f"  {cfg.name} sequential: {n_pre} prefill calls, {n_dec} decode "
          "calls; wall ms per call " + ", ".join(
              f"{k} mean {v['wall_ms_mean']:.3f} median "
              f"{v['wall_ms_median']:.3f}" for k, v in per_call.items())
          + f"; eval n_cache_hit_tokens {hits} (mixed "
          f"{mixed['eval_cache_hits']}); {agree} of {total} generated "
          f"tokens as in the mixed run (bf16); smallest top-1/top-2 logit "
          f"margin {margin:.3e}", flush=True)
    print("  sequential launches: " + ", ".join(
        f"{k} {v} ({v / len(calls):.1f}/call)" for k, v in counts.items()),
        flush=True)
    return {"prefill_calls": n_pre, "decode_calls": n_dec,
            "per_call": per_call, "launches": counts,
            "launches_per_call": {k: v / len(calls)
                                  for k, v in counts.items()},
            "launches_per_decode_call": {
                "paged_attention": counts["paged_attention"] / n_dec},
            "eval_cache_hits": hits, "other_hits": other,
            "tokens_agreeing_with_mixed": agree, "tokens": total,
            "min_top2_margin": margin,
            "step_ms_mean": statistics.mean(step_ms)}


@contextlib.contextmanager
def recorded_routes(torch):
    """Record each MoE router call while the block runs: its expert
    indices and its smallest top-k margin (k-th gate minus the (k+1)-th,
    over the call's rows, padded rows included), as device tensors."""
    from repro_torch.models import moe
    orig = moe.route
    calls = []

    def route(p, cfg, x, **kw):
        out = orig(p, cfg, x, **kw)
        k = cfg.moe.experts_per_token
        g = torch.softmax(x.float() @ p["router"], -1).topk(k + 1).values
        calls.append((out[1], (g[..., k - 1] - g[..., k]).min()))
        return out

    moe.route = route
    try:
        yield calls
    finally:
        moe.route = orig


def expert_copies(prof, cfg):
    """The copies under ``prof`` of a tensor shaped as an expert's weight
    or a layer's expert stack: (input shape, calls)."""
    m, d = cfg.moe, cfg.d_model
    shapes = {(d, m.d_ff), (m.d_ff, d), (m.num_experts, d, m.d_ff),
              (m.num_experts, m.d_ff, d)}
    return [(str(e.input_shapes), e.count)
            for e in prof.key_averages(group_by_input_shape=True)
            if e.key in ("aten::copy_", "aten::clone")
            and any(tuple(sh) in shapes for sh in e.input_shapes)]


def xkv_copies(prof, cfg):
    """The copies under ``prof`` of a tensor shaped as one or more
    requests' encoder K/V of a layer, in the pools' layout or the
    reference's: (input shape, calls)."""
    KV, Se, hd = cfg.num_kv_heads, cfg.encoder_seq_len, cfg.head_dim
    tails = {(KV, Se, hd), (Se, KV, hd)}
    return [(str(e.input_shapes), e.count)
            for e in prof.key_averages(group_by_input_shape=True)
            if e.key in ("aten::copy_", "aten::clone", "aten::index")
            and any(tuple(sh[-3:]) in tails for sh in e.input_shapes
                    if len(sh) >= 3)]


def cross_layouts(torch, eng, cfg, n: int = 4):
    """One decoder layer's cross-attention for a decode batch of ``n``
    rows over ``n`` run slots' encoder K/V, timed on the runner's
    float32 pools as they are stored and on model-dtype copies of the
    same values (the reference's layout; the products upcast them); the
    two outputs must agree within the output dtype's tolerance.  Returns
    ms per layer and per step."""
    from repro_torch.kernels.bench import Timer
    from repro_torch.models.attention import packed_cross_attention

    r, timer = eng.runner, Timer("cuda")
    dt = r.params["final_norm"].dtype
    gen = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn((n, cfg.num_heads, cfg.head_dim), generator=gen,
                    device="cuda").to(dt)
    rows = torch.arange(n, dtype=torch.int32, device="cuda")
    cols = torch.zeros((n,), dtype=torch.int32, device="cuda")
    pools = {"float32": (r.xk_pool[0, :n], r.xv_pool[0, :n]),
             str(dt).split(".")[-1]: (r.xk_pool[0, :n].to(dt),
                                      r.xv_pool[0, :n].to(dt))}
    out, res = {}, {}
    for name, (xk, xv) in pools.items():
        out[name] = packed_cross_attention(q, xk, xv, rows, cols, 2)
        ms = timer(lambda: packed_cross_attention(q, xk, xv, rows, cols, 2))
        res[name] = {"ms_per_layer": ms,
                     "ms_per_step": ms * cfg.num_layers,
                     "bytes_per_layer": 2 * xk.numel() * xk.element_size()}
    # the same products on the same values, rounded to q's dtype
    tol = TOL[str(dt).split(".")[-1]]
    err = rel_err(*out.values())[2]
    if err > tol:
        fail(f"cross-attention differs between the pool layouts: {err} of "
             f"a row's max > {tol}")
    print("  cross-attention, decode batch of 4, per layer (x "
          f"{cfg.num_layers} a step): " + "; ".join(
              f"{k} pools {v['ms_per_layer']:.4f} ms "
              f"({v['bytes_per_layer'] / 1e6:.1f} MB of K/V)"
              for k, v in res.items()) + f"; outputs within {err:.2e} of "
          "a row's max", flush=True)
    res["row_rel_err"] = err
    return res


def profile_decode(torch, eng, cfg, n_steps: int = 8):
    """Where a steady decode step's time goes: 4 running requests with
    256-token contexts (on an encoder-decoder each on its own audio),
    n_steps timed plainly, then n_steps under torch.profiler for the
    device time by kernel; on a MoE stack, no step may copy an expert's
    weights, and n_steps more record the experts the routes touch; on an
    encoder-decoder, no step may copy a request's encoder K/V."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import SSM
    from repro_torch.models.ssm import ssm_dims
    rng = np.random.RandomState(1)
    for _ in range(4):
        eng.submit(list(rng.randint(10, cfg.vocab_size, 256)),
                   4 * n_steps + 8,
                   **(audio(rng, cfg) if cfg.is_encoder_decoder else {}))
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
    touched = None
    if cfg.is_encoder_decoder:
        copies = xkv_copies(prof, cfg)
        if copies:
            fail(f"a decode step copies encoder K/V: {copies}")
        print("  encoder K/V copies per decode step: 0 (read in place from "
              "the run slots' pools)", flush=True)
    if cfg.moe is not None:
        copies = expert_copies(prof, cfg)
        if copies:
            fail(f"a decode step copies expert weights: {copies}")
        print("  no copy of an expert weight or stack in the profiled "
              "steps", flush=True)
        with recorded_routes(torch) as calls:
            for _ in range(n_steps):
                eng.step()
            torch.cuda.synchronize()
        # distinct experts per layer call, summed over a step's layers
        touched = sum(len(set(i.flatten().tolist())) for i, _ in calls) \
            / n_steps
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
    # ragged paged attention: its tile and merge kernels
    attn_ms = sum(dev_us(e) for e in kernels
                  if "paged_attention" in e.key) / 1e3 / n_steps
    state_bytes = 0
    if cfg.ssm is not None:
        # the scan's kept states: 4 request rows and 1 (padded) snapshot
        # row per SSM layer, float32
        _, nh, _ = ssm_dims(cfg)
        state_bytes = cfg.pattern().count(SSM) * (4 + 1) * nh \
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
           "attention_device_ms_per_step": attn_ms,
           "attention_share_of_busy": attn_ms / busy_ms if busy_ms else None,
           "scan_state_write_bytes_per_step": state_bytes,
           "host_us_per_eager_launch": launch_us,
           "experts_touched_per_step": touched,
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
          f"step {ops_per_step:.0f}; ragged_paged_attention {attn_ms:.3f} "
          f"ms/step; ragged_ssd_chunk_scan {scan_ms:.3f} ms/step, its "
          f"state writes {state_bytes / 1e6:.1f} MB/step", flush=True)
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


def parity(torch, arch: str, prompt_len: int = 40, mode: str = "mixed"):
    """The reduced float32 ``arch`` with two adapters cycling through one
    device slot, in execution mode ``mode``: the same weights and
    pipeline on the card and on the CPU give identical tokens,
    prefix-cache hits (KV blocks and state snapshots), ``state_reused``
    and adapter evictions.  (The reduced starcoder2 is given prompts
    longer than its 128-token window; the reduced phi-3-vision serves on
    images of its 16 patches, the reduced whisper on audio of its 64
    frames; the MoE models report their routes' smallest top-k margin,
    the sequential runs their logits' smallest top-1/top-2 margin.)  The
    card's run is returned under "card_run"."""
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
    runs, margins, logit_margins = {}, {}, {}
    for device in ("cuda", "cpu"):
        eng = Engine(cfg, params, device=device, adapters=adapters,
                     engine_cfg=EngineConfig(adapter_slots=1,
                                             execution_mode=mode))
        with recorded_routes(torch) as calls, \
                sequential_calls(torch, eng) as seq:
            res, _ = run_pipeline(torch, eng, adapter_names=("eval", "lora"),
                                  prompt_len=prompt_len, gen_len=12,
                                  eval_len=6, batch=3, seed=3)
        if calls:
            margins[device] = min(float(m) for _, m in calls)
        if seq:
            logit_margins[device] = min(m for _, _, m in seq)
        reqs = [eng.request(i) for i in res.base_ids + res.eval_ids]
        runs[device] = dict(
            tokens=[r.output_tokens for r in reqs],
            hits=[r.n_cache_hit_tokens for r in reqs],
            state_reused=[r.state_reused for r in reqs],
            kv_hits=eng.kv_mgr.hits if eng.kv_mgr is not None else None,
            state_hits=eng.st_mgr.hits if eng.st_mgr is not None else None,
            evictions=eng.adapter_pool.evictions)
    if runs["cuda"] != runs["cpu"]:
        fail(f"{arch} {mode}: card and CPU disagree: {runs}")
    r = runs["cpu"]
    print(f"  {cfg.name} {mode}: card == CPU (prompts of {prompt_len}, G "
          f"{cfg.num_heads // cfg.num_kv_heads}, window {cfg.sliding_window},"
          f" {cfg.activation}): {len(r['tokens'])} requests, KV hits "
          f"{r['kv_hits']}, state hits {r['state_hits']}, state_reused "
          f"{sum(r['state_reused'])}, adapter evictions {r['evictions']}",
          flush=True)
    if cfg.ssm is not None and not any(r["state_reused"]):
        fail(f"{arch}: no request restored a state snapshot")
    if margins:
        # the card's and the CPU's float32 router logits differ in their
        # order of sums: a route can flip only where this is near 1e-7
        print(f"  smallest top-{cfg.moe.experts_per_token} margin of the "
              f"run's routes: card {margins['cuda']:.3e}, CPU "
              f"{margins['cpu']:.3e}", flush=True)
    if logit_margins:
        print(f"  smallest top-1/top-2 logit margin of the sequential calls: "
              f"card {logit_margins['cuda']:.3e}, CPU "
              f"{logit_margins['cpu']:.3e}", flush=True)
    if cfg.frontend == "vision":
        print(f"  {cfg.num_patches}-patch image prefix on every base and "
              "eval request", flush=True)
    if cfg.frontend == "audio":
        print(f"  {cfg.encoder_seq_len} audio frames on every request",
              flush=True)
    out = {k: r[k] for k in ("kv_hits", "state_hits", "evictions")}
    if margins:
        out["min_topk_margin"] = margins
    if logit_margins:
        out["min_top2_logit_margin"] = logit_margins
    out["card_run"] = runs["cuda"]
    return out


def bench_path(torch):
    """Phase 5: the kernel-bench entry point at full width, every kernel
    count set to 0 just before and read just after.  Each of its three
    kernels must launch, and each case's kernel output must be finite and
    within tolerance of its plain version.  Then, at the bench's
    attention cases made anew from its seed, a NaN in the pool's last
    block, which every table entry past a length points at, must change
    no output."""
    from repro_torch.kernels import bench
    reset_counts()
    t0 = time.perf_counter()
    res = bench.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted().items()}
    print(f"  bench {seconds:.1f} s; launches: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()), flush=True)
    for name in ("paged_attention", "ssd_chunk_scan", "alora_qkv"):
        if launches[name] == 0:
            fail(f"the kernel bench never launched {name}")
    for key, r in res.items():
        r["tol"] = TOL[r["dtype"]]
        rel = r["row_rel_err"] if "row_rel_err" in r else r["rel_err"]
        if not r["finite"] or rel > r["tol"]:
            fail(f"bench {key}: finite {r['finite']}, {rel} of max|plain| "
                 f"> {r['tol']}")
    for case in bench.cases("cuda"):
        if case.kernel != "paged_attention":
            break
        kernel = bench.WRAPPERS[case.kernel][0]
        clean = kernel(*case.args, **case.kwargs)
        k, v = case.args[1:3]
        k[-1] = float("nan")
        v[-1] = float("nan")
        again = kernel(*case.args, **case.kwargs)
        torch.cuda.synchronize()
        if not torch.equal(again, clean):
            fail(f"paged_attention/{case.name}: a NaN in the block past "
                 "every length reached the output")
        print(f"  paged_attention/{case.name}: a NaN in the block past "
              "every length changes no output", flush=True)
        del case, clean, again
    return res, launches, seconds


def kernel_entry(name, source, replaces, launches, steps, check, **extra):
    """One entry of the ``kernels`` line: the fields every kernel has,
    then what is particular to it."""
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "launches_per_step": launches / steps}
    for k in ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms"):
        entry[k] = check[k]
    entry["tol_of"] = TOL_OF
    entry.update(extra)
    return entry


def bench_entry(name, source, replaces, launches, bres, edges, case,
                others=()):
    """The ``kernels`` entry of a kernel the bench entry point drives:
    its launches in that run (one bench call, hence launches_per_step),
    error and times from that run for ``case``, then the same for its
    ``others``, and its errors at phase 2's edge shapes."""
    def fields(c):
        r = bres[f"{name}/{c}"]
        out = {"case": c, "shape": r["shape"], "dtype": r["dtype"]}
        for k in ("max_abs_err", "rel_err", "row_rel_err", "tol", "ms",
                  "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "library_device_ms", "base_gemm_ms", "base_gemm_device_ms",
                  "device_split_ms", "device_span_ms"):
            if k in r:
                out[k] = r[k]
        out.setdefault("library_ms", None)
        return out

    first = fields(case)
    return kernel_entry(name, source, replaces, launches[name], 1, first,
                        per="bench call",
                        **{k: v for k, v in first.items()
                           if k not in ("max_abs_err", "tol", "ms",
                                        "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
                        others=[fields(c) for c in others],
                        edge_rel_err={k.split("/", 1)[1]: v
                                      for k, v in edges.items()
                                      if k.startswith(name + "/")})


def sequential_entry(name, source, replaces, mp, seq, case, others,
                     bench):
    """The ``kernels`` entry of a kernel the sequential step launches
    (B4, B6): its launches in granite-3.2-8b's sequential run, the error
    and times at phase 2's serving-shape ``case``, then the same for its
    ``others``, the launches of every sequential run, and the kernel
    bench's entry for it (``bench``)."""
    g = mp["granite-3.2-8b"]["sequential"]
    first = seq[f"{name}/{case}"]
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": g["launches"][name],
             "launches_per_call": g["launches_per_call"][name],
             "path": "granite-3.2-8b, sequential execution mode",
             "case": case}
    fields = ("max_abs_err", "rel_err", "row_rel_err", "tol", "ms",
              "plain_ms", "bound_ms", "bound_by", "library_ms",
              "base_gemm_ms", "device_split_ms", "device_span_ms", "shape")
    entry.update({k: first[k] for k in fields if k in first})
    entry["tol_of"] = TOL_OF
    entry["others"] = {c: {k: seq[f"{name}/{c}"][k] for k in fields
                           if k in seq[f"{name}/{c}"]} for c in others}
    entry["launches_sequential"] = {
        a: mp[a]["sequential"]["launches"][name] for a in SEQ_ARCHS}
    entry["calls_sequential"] = {
        a: mp[a]["sequential"]["prefill_calls"]
        + mp[a]["sequential"]["decode_calls"] for a in SEQ_ARCHS}
    entry["bench"] = bench
    return entry


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.bench import Timer

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
            "zamba2": get_config("zamba2-2.7b"),
            **{k: get_config(a) for k, a in zip(DENSE + MOE_VLM,
                                                DENSE_ARCHS + MOE_VLM_ARCHS)},
            "whisper": get_config(ENCDEC_ARCH)}
    cfg = cfgs["granite"]
    gen = torch.Generator().manual_seed(0)
    timer = Timer("cuda")
    attn = check_attention(torch, cfgs, timer, gen)
    attn_edges = check_attention_edges(torch, gen)
    lora = check_lora(torch, cfgs, timer, gen)
    lora_edges = check_lora_edges(torch, cfgs, gen)
    scan = check_ssd_scan(torch, timer, gen)
    scan_edges = check_scan_edges(torch, gen)
    edges = check_bench_edges(torch)
    moe_layer = check_moe(torch, cfgs, timer)
    seq_kernels = check_sequential_kernels(torch, cfgs, timer)
    del timer
    torch.cuda.empty_cache()

    print("[3] main path, full width", flush=True)
    mp = {}
    for arch in ("granite-3.2-8b", "mamba2-2.7b", "zamba2-2.7b",
                 *DENSE_ARCHS):
        print(f" [3] {arch}", flush=True)
        mp[arch] = main_path(torch, arch,
                             profile=arch != "zamba2-2.7b",
                             long=arch == "starcoder2-3b",
                             sequential=arch in SEQ_ARCHS)
    for arch in MOE_VLM_ARCHS + (ENCDEC_ARCH,):
        print(f" [3] {arch}", flush=True)
        mp[arch] = main_path(torch, arch, profile=True, num_layers=(
            PHIMOE_LAYERS if arch == "phi3.5-moe-42b-a6.6b" else 0),
            sequential=arch in SEQ_ARCHS)

    print("[4] parity, reduced fp32, card vs CPU", flush=True)
    par = {arch: parity(torch, arch)
           for arch in ("granite-3.2-8b", "mamba2-2.7b", "zamba2-2.7b",
                        *DENSE_ARCHS[:3], *MOE_VLM_ARCHS, ENCDEC_ARCH)}
    # past the reduced starcoder2's 128-token window
    par["starcoder2-3b"] = parity(torch, "starcoder2-3b", prompt_len=150)
    par["slot_rank"] = slot_rank_card(torch)
    # the sequential mode on the card against the CPU, then against the
    # mixed run on the card
    for arch in ("granite-3.2-8b", "mamba2-2.7b", "zamba2-2.7b",
                 ENCDEC_ARCH):
        par[f"{arch}/sequential"] = seq = parity(torch, arch,
                                                 mode="sequential")
        mixed, got = par[arch]["card_run"], seq["card_run"]
        for k in ("tokens", "hits", "state_reused"):
            if got[k] != mixed[k]:
                fail(f"{arch}: sequential != mixed on the card ({k}): "
                     f"{got[k]} vs {mixed[k]}")
        print(f"  {arch}: sequential == mixed on the card (tokens, hits, "
              "state_reused)", flush=True)
    for r in par.values():
        r.pop("card_run", None)

    print("[5] kernel bench entry point, full width", flush=True)
    bres, blaunch, bsec = bench_path(torch)

    g, m, z = (mp[a] for a in ("granite-3.2-8b", "mamba2-2.7b",
                               "zamba2-2.7b"))
    a16 = attn["bfloat16"]
    pick = lambda e, *keys: {k: e[k] for k in keys}  # noqa: E731
    timed = ("ms", "device_split_ms", "plain_ms", "bound_ms", "bound_by",
             "T")
    lq, lm = lora["bfloat16_qkv"], lora[next(
        k for k in lora if k.startswith("bfloat16_mamba2_in_proj"))]
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
            device_split_ms=a16["device_split_ms"],
            decode8={k: a16["decode8"][k] for k in
                     ("ms", "plain_ms", "library_ms", "bound_ms",
                      "bound_by", "device_split_ms")},
            long_context={k: a16["long"][k] for k in
                          ("context", "table_blocks", "splits",
                           "grid_blocks", "scratch_bytes", "row_rel_err",
                           "ms", "plain_ms", "library_ms", "bound_ms",
                           "bound_by", "device_split_ms")},
            zamba2={k: attn["zamba2_bfloat16"][k] for k in
                    ("max_abs_err", "row_rel_err", "tol", "ms", "plain_ms",
                     "library_ms", "bound_ms", "bound_by",
                     "device_split_ms")},
            decode_attention_device_ms_per_step=g["decode_profile"][
                "attention_device_ms_per_step"],
            dense={key: {k: v for k, v in attn[key].items()
                         if k != "bytes" and k != "ops"}
                   for key in attn if key.split("_")[0] in DENSE_ATTN},
            launches_dense={a: mp[a]["launches"]["ragged_paged_attention"]
                            for a in DENSE_ARCHS},
            launches_per_step_dense={
                a: mp[a]["launches_per_step"]["ragged_paged_attention"]
                for a in DENSE_ARCHS},
            launches_starcoder2_long=mp["starcoder2-3b"]["long"][
                "launches"]["ragged_paged_attention"],
            decode_attention_device_ms_per_step_dense={
                a: mp[a]["decode_profile"]["attention_device_ms_per_step"]
                for a in DENSE_ARCHS},
            moe_vlm={key: {k: v for k, v in attn[key].items()
                           if k != "bytes" and k != "ops"}
                     for key in attn if key.split("_")[0] in NEW_ATTN},
            launches_moe_vlm={
                a: mp[a]["launches"]["ragged_paged_attention"]
                for a in MOE_VLM_ARCHS},
            launches_per_step_moe_vlm={
                a: mp[a]["launches_per_step"]["ragged_paged_attention"]
                for a in MOE_VLM_ARCHS},
            decode_attention_device_ms_per_step_moe_vlm={
                a: mp[a]["decode_profile"]["attention_device_ms_per_step"]
                for a in MOE_VLM_ARCHS},
            encdec={key: {k: v for k, v in attn[key].items()
                          if k != "bytes" and k != "ops"}
                    for key in attn if key.split("_")[0] in ENCDEC},
            launches_whisper=mp[ENCDEC_ARCH]["launches"][
                "ragged_paged_attention"],
            launches_per_step_whisper=mp[ENCDEC_ARCH]["launches_per_step"][
                "ragged_paged_attention"],
            decode_attention_device_ms_per_step_whisper=mp[ENCDEC_ARCH][
                "decode_profile"]["attention_device_ms_per_step"],
            edge_rel_err=attn_edges),
        kernel_entry(
            "ragged_grouped_lora", "src/repro_torch/csrc/ragged_lora.cu",
            "src/repro/kernels/ragged_lora.py:82",
            m["launches"]["ragged_grouped_lora"], m["steps"], lm,
            path="mamba2-2.7b (SSM input projection)",
            device_split_ms=lm["device_split_ms"],
            decode4=pick(lm["decode4"], *timed, "max_abs_err",
                         "rel_err"),
            launches_zamba2=z["launches"]["ragged_grouped_lora"],
            launches_zamba2_sequential=z["sequential"]["launches"][
                "ragged_grouped_lora"],
            zamba2_in_proj={k: v for k, v in lora.items()
                            if k.startswith("bfloat16_zamba2_in_proj")}),
        kernel_entry(
            "ragged_grouped_lora_qkv", "src/repro_torch/csrc/ragged_lora.cu",
            "src/repro/kernels/ragged_lora.py:82",
            g["launches"]["ragged_grouped_lora_qkv"], g["steps"], lq,
            path="granite-3.2-8b (fused Q/K/V deltas)",
            device_split_ms=lq["device_split_ms"],
            decode4=pick(lq["decode4"], *timed, "max_abs_err",
                         "rel_err"),
            max_abs_err_fp32=lora["float32_qkv"]["max_abs_err"],
            tol_fp32=TOL["float32"],
            launches_zamba2=z["launches"]["ragged_grouped_lora_qkv"],
            zamba2=pick(lora["bfloat16_zamba2_qkv"], "max_abs_err",
                        "rel_err", *timed),
            zamba2_decode4=pick(lora["bfloat16_zamba2_qkv"]["decode4"],
                                "max_abs_err", "rel_err", *timed),
            adapted_granite=g["adapted"],
            dense={a: {**pick(lora[f"bfloat16_{a}_qkv"], "d", "out",
                              "max_abs_err", "rel_err", *timed),
                       "decode4": pick(lora[f"bfloat16_{a}_qkv"]["decode4"],
                                       "max_abs_err", "rel_err", *timed)}
                   for a in DENSE},
            launches_dense={a: mp[a]["launches"]["ragged_grouped_lora_qkv"]
                            for a in DENSE_ARCHS},
            moe_vlm={a: {**pick(lora[f"bfloat16_{a}_qkv"], "d", "out",
                                "max_abs_err", "rel_err", *timed),
                         "decode4": pick(lora[f"bfloat16_{a}_qkv"]["decode4"],
                                         "max_abs_err", "rel_err", *timed)}
                     for a in NEW_ATTN},
            launches_moe_vlm={
                a: mp[a]["launches"]["ragged_grouped_lora_qkv"]
                for a in MOE_VLM_ARCHS},
            launches_per_step_moe_vlm={
                a: mp[a]["launches_per_step"]["ragged_grouped_lora_qkv"]
                for a in MOE_VLM_ARCHS},
            whisper={**pick(lora["bfloat16_whisper_qkv"], "d", "out",
                            "max_abs_err", "rel_err", *timed),
                     "decode4": pick(lora["bfloat16_whisper_qkv"]["decode4"],
                                     "max_abs_err", "rel_err", *timed)},
            launches_whisper=mp[ENCDEC_ARCH]["launches"][
                "ragged_grouped_lora_qkv"],
            launches_per_step_whisper=mp[ENCDEC_ARCH]["launches_per_step"][
                "ragged_grouped_lora_qkv"],
            edge_rel_err=lora_edges),
        kernel_entry(
            "ragged_ssd_chunk_scan", "src/repro_torch/csrc/ssd_chunk.cu",
            "src/repro/kernels/ssd_chunk.py:178",
            m["launches"]["ragged_ssd_chunk_scan"], m["steps"],
            scan["mamba2"],
            row_rel_err_y=scan["mamba2"]["row_rel_err_y"],
            row_rel_err_states=scan["mamba2"]["row_rel_err_states"],
            kept_rows=scan["mamba2"]["kept_rows"],
            device_split_ms=scan["mamba2"]["device_split_ms"],
            decode4=pick(scan["mamba2"]["decode4"], *timed),
            launches_zamba2=z["launches"]["ragged_ssd_chunk_scan"],
            launches_per_step_zamba2=z["launches"]["ragged_ssd_chunk_scan"]
            / z["steps"],
            n64={k: scan["zamba2"][k] for k in
                 ("max_abs_err", "ms", "device_split_ms", "plain_ms",
                  "bound_ms", "bound_by")},
            n64_decode4=pick(scan["zamba2"]["decode4"], *timed),
            edge_rel_err=scan_edges),
        sequential_entry(
            "paged_attention", "src/repro_torch/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:141", mp, seq_kernels,
            "granite_decode4", ("zamba2_decode4", "whisper_decode4"),
            bench_entry("paged_attention",
                        "src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:141", blaunch,
                        bres, edges, "granite_bf16",
                        others=("granite_f32_window24",))),
        bench_entry("ssd_chunk_scan", "src/repro_torch/csrc/ssd_chunk_dense.cu",
                    "src/repro/kernels/ssd_chunk.py:73", blaunch, bres, edges,
                    "mamba2_N128", others=("zamba2_N64",)),
        sequential_entry(
            "alora_qkv", "src/repro_torch/csrc/alora_qkv.cu",
            "src/repro/kernels/alora_qkv.py:45", mp, seq_kernels,
            "granite_q_T4", ("granite_q_T64", "granite_q_T128",
                             "granite_kv_T4", "granite_kv_T64",
                             "granite_kv_T128", "zamba2_q_T4",
                             "zamba2_q_T64", "zamba2_q_T128", "whisper_q_T4",
                             "whisper_q_T64", "whisper_q_T128"),
            bench_entry("alora_qkv", "src/repro_torch/csrc/alora_qkv.cu",
                        "src/repro/kernels/alora_qkv.py:45", blaunch, bres,
                        edges, "granite_bf16_T512",
                        others=("granite_bf16_T128", "granite_f32_T128"))),
    ]
    print(json.dumps({"main_path": mp, "parity": par, "moe_layer": moe_layer,
                      "sequential_kernels": seq_kernels,
                      "bench": bres,
                      "bench_seconds": bsec, "card": card,
                      "seconds": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
