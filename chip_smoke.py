#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. card and setup: the card's name and power limit, the torch/CUDA
   versions, TF32 off, the build of the CUDA kernels from
   ``src/repro_torch/csrc`` (timed), and the port's static analyzer
   (``python -m repro_torch.analysis --skip-audit``: the hot-path lint
   and the resource-lifecycle check over
   ``repro_torch/{serving,kernels,obs}`` and the sharded step's
   ``distributed/parallel.py``; any violation fails; its step audit is
   phase 11);
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
   K/V width at T = 4, 64 and 128 on one rank-32 adapter slot); then the
   fused Q/K/V LoRA entry at the vanilla-LoRA baseline's plan (granite's
   widths, bf16, one rank-8 slot, every row on it: a 128-row prefill
   chunk and a T = 4 decode step), timed;
3. the main paths at full width, random weights from a seed, each
   serving the paper's base → aLoRA pipeline through the mixed step with
   every kernel count set to 0 just before and read just after:
   granite-3.2-8b (attention), mamba2-2.7b (pure SSM; 16 of its 64
   layers), zamba2-2.7b
   (hybrid), the dense families stablelm-12b, minitron-4b,
   nemotron-4-15b and starcoder2-3b (at half their depth: 20, 16, 16 and
   15 layers), the MoE models granite-moe-1b-a400m
   and phi3.5-moe (24 of its 32 layers: all 32 do not fit on the card),
   phi-3-vision-4.2b (16 of its 32 layers) on images (576 patch embeddings under
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
   raises at construction; then the reduced float32 granite behind a
   two-replica affinity router (the reference router tests' multi-turn
   trace, 5 sessions × 2 turns, three adapters) on the card and on the
   CPU — identical placements, tokens, hits and fleet hit rate — and the
   card's fleet emits one engine's tokens;
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
   attention's output unchanged at the bench's full-width cases;
6. the serving tier on granite-3.2-8b at full width, one copy of its
   random weights on the card: the launcher (``repro_torch.launch.serve``:
   a warm-up pass and a measured pass of 4 base → adapter → base
   pipelines, gen 32, eval 16, for the rank-8 vanilla-LoRA baseline and
   then rank-32 aLoRA, each stage's metrics and the eval speedups) at
   prompts of 128 and 1,024 tokens on granite's first ``LAUNCH_LAYERS``
   (20) layers, every kernel count set to 0 just
   before and read just after each: one B1 and one fused B2 call per
   layer and mixed step, every aLoRA eval reusing the base request's
   computed full blocks (144 and 1,040 tokens), every LoRA eval none, the
   final base request reusing the base blocks (unless the LoRA evals
   evicted them), the aLoRA run's Perfetto JSON and Prometheus text
   written and parsed back; then two engine replicas sharing the
   weights (the same ``data_ptr``; ``memory_allocated`` after each)
   behind the router on the reference router tests' multi-turn trace
   (5 sessions × 4 turns, prompts of 256+ tokens, base and aLoRA turns
   alternating) under ``affinity`` (each later turn on its previous
   turn's replica with a cached prefix; the fleet's trace and counters
   written and parsed back: one phase process per replica and the
   router's, reused tokens = ledger = hits × block size), under
   ``round_robin`` (a lower fleet hit rate) and under ``affinity`` with
   ``stop_replica(1)`` mid-run (no request lost, re-routes counted), with
   the wall ms per router step and the merged throughput;
7. the paper's benches and examples through their entry points
   (``repro_torch.benchmarks``, ``repro_torch.examples``), each leg's
   launches counted (B1 and B2's fused entry once per attention layer of
   a mixed step, B3 once per SSM layer, B2's one-pair entry once per SSM
   layer of a mixed step or a sequential call) with its wall seconds,
   mixed steps and mean wall ms a mixed step: (a) every bench's
   ``--smoke`` leg on the reduced float32 models with every reference
   assert (Figs. 6/12, 11, 15, 10 and 8/9 at their first sweep point
   (Fig. 6: every aLoRA eval reusing prompt tokens, no LoRA eval), §4.4.1,
   adapter churn against the sequential oracle, the Zipf leg's FCFS
   oracle against the affinity scheduler, sequential / mixed / async
   mixed with the 2 % tracing budget, the router at R = 1 and 2, and
   mamba2's mixed-batch leg); (b) every bench at granite-3.2-8b's full
   width, depth cut to ``PAPER_LAYERS``, in bf16 (random weights from a
   seed, one copy on the card), one warm-up and one measured pass, with
   the sweep points and the Zipf trace cut to ``FULL_SWEEPS`` and
   ``ZIPF_FULL``; (c) the three examples on the same weights;
8. the full-sequence model and training (``repro_torch.models.model``'s
   ``forward_full``, ``prefill_to_decode_caches`` and ``decode_step``,
   ``repro_torch.training``), each kernel count set to 0 just before each
   run and read just after: B6 against its plain version at T = 2,048
   and 2; granite-3.2-8b at full width and depth with four aLoRA
   adapters (``forward_full`` and 16 ``decode_step``s, B6 120 launches
   each); mamba2-2.7b at full width and depth (B5 64 launches a no-grad
   ``forward_full`` and 0 under grad, B2's one-pair entry 64 on an
   adapted one, each held against its plain version on that run's
   inputs); ten AdamW steps at granite's widths x 16 layers; and the
   reduced float32 models card == CPU (forward, greedy decode, a train
   step, int8 caches, the engine against ``decode_step``);
9. the sharded mixed step (``EngineConfig.mesh``, ``repro_torch.
   distributed``) on ranks that share the card (``distributed.spawn``,
   gloo; any rank's failure fails the phase): (a) the reduced float32
   granite, mamba2 and whisper at (data=1, model=2) and (2, 2), granite
   at (1, 4) (its two K/V heads replicated), a preemption case at (2,
   2) and granite's full widths × ``TP_WIDE_LAYERS`` layers in float32
   at (1, 2), each equal to the unsharded card engine on the reference
   test's workload (tokens, reused tokens, evictions, preemptions,
   steps) with per-layer launches on every rank; (b) granite-3.2-8b at full width
   and depth in bf16 at model=2 through phase 3's pipeline, the weights
   drawn as phase 3 draws them and cut to each rank's slice layer by
   layer: 40 B1 and 40 fused B2 a mixed step on each rank, the evals'
   reuse equal to phase 3's, the GB of weights a rank, the wall ms a
   mixed step, the token agreement with phase 3 (printed), the wall ms
   of a collective, and rank 0's device busy ms a decode step with its
   copies' share (``torch.profiler``); (c) mamba2-2.7b at full width,
   ``MAMBA_TP_LAYERS`` of its 64 layers, model=2: B3 and B2's one-pair
   entry once per SSM layer of each rank's mixed step, every eval
   restoring a state snapshot;
10. the sharded full-sequence model, decode step and training
   (``Runtime.mesh``: tensor-parallel over ``model``, the batch over
   ``data``, expert-parallel MoE, context-parallel prefill, ZeRO-1) on
   ranks sharing the card: (a) reduced float32 at (data, model) = (1, 2)
   and (2, 2), each against the port's unsharded card run
   (``repro_torch.benchmarks.sharded_model``): granite adapted
   (``forward_full`` and 16 greedy decode steps; also at (1, 4),
   its K/V heads replicated), mamba2 adapted (B5 on each rank's heads,
   B2's one-pair entry on its in-projection columns) and
   whisper, granite-moe's expert-parallel layer at capacity factors 32
   and 0.05, stablelm's context-parallel forward and gradients, and one
   TP + ZeRO-1 train step on granite and granite-moe: hidden states,
   logits and gradients within 1e-5 of max, tokens exact, the train
   step's loss, grad norm, params and moments within 1e-5; (b) full
   width, bf16, model=2: granite-3.2-8b ``forward_full`` on 2 × 1,024
   tokens with four rank-32 adapters (120 B6 a forward on each rank, 120
   a ``decode_step``), mamba2-2.7b at ``FM_MAMBA_LAYERS`` layers (B5 once
   a layer on each rank, B2's one-pair entry once a layer adapted), a TP
   + ZeRO-1 train step at granite's widths × ``FM_TRAIN["layers"]``
   layers at (2, 2): wall ms and peak GB a rank, and layer 0's B6
   (Q, K and V, forward and decode step), B5 and B2 calls on each
   rank's slice held against their plain versions on the same
   tensors; (c) the dry run
   (``repro_torch.launch.dryrun``) on both production meshes, and its
   per-rank param bytes of granite-3.2-8b at model=2 equal to phase 9's
   measured bytes on a rank;
11. the step audit (Pass A, ``repro_torch.analysis.step_audit``): (a)
   ``python -m repro_torch.analysis --device cuda --skip-lint`` over
   every config at 1x1 and at data=2 × model=4 (one world of 8 ranks
   sharing the card): no violation, and every collective fingerprint
   equal to the goldens made on the CPU; (b) and (c), run at the end of
   phase 3's serves of granite-3.2-8b (full width and depth, bf16) and
   mamba2-2.7b (16 layers) on the engines that served them (their
   weights are on the card only then), each on the batches of a short
   capture serve on that engine after its timed one: no violation under ``torch.cuda.set_sync_debug_mode("error")``,
   the traced step launching B1 and B2's fused entry once per attention
   layer (40 each on granite) and B3 and B2's one-pair entry once per
   SSM layer, the memory record and A5's allowed finding (mamba2's
   float32 ``out_proj``, ROADMAP B'2) printed.

``PERF.md`` gives its run time on one H100, the kernels' build included.

The line before the last is the ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``.  The script imports nothing
of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
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
# phase 3's depth (0: every layer), cut because its steps are host-bound
# and their wall grows with depth: phi3.5-moe's cut, half the layers of
# the dense families and phi-3-vision, and mamba2 at phase 9's
# ``MAMBA_TP_LAYERS`` (16), so that phase 9 compares its sharded tokens
# with these; granite (phase 9 at full depth), zamba2, granite-moe and
# whisper serve every layer
PHASE3_LAYERS = {"phi3.5-moe-42b-a6.6b": PHIMOE_LAYERS,
                 "mamba2-2.7b": 16,
                 "stablelm-12b": 20, "minitron-4b": 16,
                 "nemotron-4-15b": 16, "starcoder2-3b": 15,
                 "phi-3-vision-4.2b": 16}
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


def check_lora_rank8(torch, cfgs, timer, gen):
    """The vanilla-LoRA baseline's plan of the fused Q/K/V entry (the
    launcher's LoRA leg, phase 6): granite's widths, bfloat16, one
    rank-8 slot (the only one, active), every row on it — a 128-row
    prefill chunk and a T = 4 decode step — within TOL of the plain
    version, timed beside its bound."""
    g = cfgs["granite"]
    widths = (g.num_heads * g.head_dim, g.num_kv_heads * g.head_dim,
              g.num_kv_heads * g.head_dim)
    d, r = g.d_model, 8
    res = {}
    for T in (128, 4):
        x = torch.randn((T, d), generator=gen).to("cuda", torch.bfloat16)
        pairs = []
        for out in widths:
            a = torch.randn((2, d, r), generator=gen) / d ** 0.5
            b = torch.randn((2, r, out), generator=gen) * (0.02 / r ** 0.5)
            a[0] = 0
            b[0] = 0
            pairs.append((a.to("cuda", torch.bfloat16),
                          b.to("cuda", torch.bfloat16)))
        idx = torch.ones(T, dtype=torch.int32, device="cuda")
        act = torch.ones(1, dtype=torch.int32, device="cuda")
        _, call = lora_call(pairs)
        got = call(x, pairs, idx, act)
        want = lora_plain(x, pairs, idx, act)
        torch.cuda.synchronize()
        err, rel, row_rel = lora_errors(got, want)
        if rel > TOL["bfloat16"]:
            fail(f"grouped LoRA rank 8, all {T} rows on one slot: max|err| "
                 f"{err} = {rel} of max|plain| > {TOL['bfloat16']}")
        key = f"bfloat16_qkv_r8_all_T{T}"
        res[key] = {"d": d, "out": list(widths), "rank": r,
                    "max_abs_err": err, "rel_err": rel,
                    "row_rel_err": row_rel, "tol": TOL["bfloat16"],
                    **time_lora(timer, x, pairs, idx, act, "bfloat16")}
        e = res[key]
        print(f"  grouped LoRA {key}: max|err| {err:.3e} (rel {rel:.3e}); "
              f"kernel {e['ms']:.4f} ms (device " + ", ".join(
                  f"{k} {v:.4f}" for k, v in e["device_split_ms"].items())
              + f"), plain {e['plain_ms']:.3f} ms, bound "
              f"{e['bound_ms']:.5f} ms ({e['bound_by']})", flush=True)
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
    32- and 64-token chunks), P 40 (off its 16-column warp slices), N 16
    (the reduced SSM models'), 32, 64 and 128, with Bt * H = 6 (P cut
    into slices) and 140 (whole-P blocks).  Within TOL of max |plain|, of each row for attention.
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
    for N in (16, 32, 64, 128):
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
    if arch in AUDIT_ARCHS:
        summary["step_audit"] = audit_served(torch, eng, arch)
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
    if arch in TP_ARCHS[:2]:
        # phase 9 holds its sharded runs to these
        summary["tp_outputs"] = outputs
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


# ---------------------------------------------------------------------------
# phase 6: the serving launcher and the multi-replica fleet
# ---------------------------------------------------------------------------
# the launcher's prompt lengths: its default, then one where prefill work
# dominates
LAUNCH_PROMPTS = (128, 1024)
# the launcher runs serve granite-3.2-8b's widths at 20 of its 40 layers
# (the first 20 of the fleet's weights), for the smoke's time budget:
# their steps are host-bound, and their wall grows with the layers
LAUNCH_LAYERS = 20
# ``tests/test_router.py::run_trace`` at full width: 4 turns, prompts of
# 256 + 4 (s % 3) tokens; 5 sessions, as the reference's trace has (with
# an even count, round robin's cycle would put every session on the same
# replica each turn, which is affinity's placement too)
FLEET = dict(sessions=5, turns=4, gen=16, prompt_len=256, seed=3)
# the drain run stops replica 1 at turn 2, after one router step taken
# between submitting session 2 and session 3
FLEET_STOP = (2, 3)


@contextlib.contextmanager
def mixed_steps():
    """Record every mixed step any engine submits while the block runs:
    (adapter slot rank, packed tokens, adapted tokens, active slots)."""
    from repro_torch.serving.runner import ModelRunner
    orig = ModelRunner.submit_batch
    steps = []

    def recorded(self, mb):
        al = self.adapter_layers[0]
        steps.append((0 if al is None else al["aq"].shape[-1],
                      len(mb.adapter_idx), int((mb.adapter_idx > 0).sum()),
                      0 if mb.active_slots is None
                      else len(mb.active_slots)))
        return orig(self, mb)

    ModelRunner.submit_batch = recorded
    try:
        yield steps
    finally:
        ModelRunner.submit_batch = orig


def fleet_trace(router, cfg, *, sessions, turns, gen, prompt_len, seed,
                stop=None):
    """``tests/test_router.py::run_trace`` on ``router``: turn k+1 extends
    turn k's prompt + generated tokens + 12 new ones; even turns go to
    the base model, odd ones to adapters ad0/ad1 by session.  With
    ``stop=(turn, session)``, one router step is taken before that
    session of that turn is submitted, and replica 1 is stopped once the
    turn is submitted.  Returns (router-global ids in submit order,
    requests re-routed by the stop)."""
    rng = np.random.RandomState(seed)
    hi = min(400, cfg.vocab_size)
    convo = [list(rng.randint(10, hi, prompt_len + 4 * (s % 3)))
             for s in range(sessions)]
    gids, moved = [], None
    for t in range(turns):
        round_ids = []
        for s in range(sessions):
            if stop == (t, s):
                router.step()
            adapter = f"ad{s % 2}" if t % 2 else None
            round_ids.append(router.submit(convo[s], gen,
                                           adapter_name=adapter))
        if stop is not None and t == stop[0]:
            moved = router.stop_replica(1)
        router.run_until_idle()
        for s, gid in enumerate(round_ids):
            out = router.request(gid).output_tokens
            if len(out) != gen:
                fail(f"fleet request {gid}: {len(out)} tokens, not {gen}")
            convo[s] = convo[s] + list(out) + list(rng.randint(10, hi, 12))
        gids.extend(round_ids)
    return gids, moved


def fleet_parity(torch):
    """Phase 4's fleet: the reduced float32 granite behind a two-replica
    affinity router on ``fleet_trace``'s reduced shape (three adapters,
    B scaled 30x as the reference's router tests scale them), on the card
    and on the CPU — identical placements, tokens, per-request hits and
    fleet hit rate — and the card's fleet emits the tokens of one engine
    on the card."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.alora import AdapterSpec, init_adapter_weights
    from repro_torch.models.model import init_params
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.serving.router import Router

    cfg = get_reduced("granite-3.2-8b")
    gen = torch.Generator().manual_seed(1)
    params = init_params(gen, cfg, device="cpu")
    adapters = []
    for i in range(3):
        w = init_adapter_weights(gen, cfg, 8, device="cpu")
        adapters.append((AdapterSpec(f"ad{i}", 8, INV if i % 2 else None),
                         {seg: {k: v * 30 if k.startswith("b") else v
                                for k, v in leaves.items()}
                          for seg, leaves in w.items()}))
    ecfg = EngineConfig(max_running=4, max_batched_tokens=64,
                        adapter_slots=2)
    runs = {}
    for device, n in (("cuda", 2), ("cpu", 2), ("cuda", 1)):
        router = Router([Engine(cfg, params, device=device,
                                adapters=adapters, engine_cfg=ecfg)
                         for _ in range(n)])
        gids, _ = fleet_trace(router, cfg, sessions=5, turns=2, gen=5,
                              prompt_len=24, seed=3)
        reqs = [router.request(g) for g in gids]
        runs[device, n] = dict(
            placements=[(p.req_id, p.replica, p.cached_tokens,
                         p.adapter_resident, p.via_session)
                        for p in router.placements],
            tokens=[r.output_tokens for r in reqs],
            hits=[r.n_cache_hit_tokens for r in reqs],
            kv_hits=[e.kv_mgr.hits for e in router.replicas],
            kv_hit_rate=router.kv_hit_rate())
    card, cpu = runs["cuda", 2], runs["cpu", 2]
    if card != cpu:
        fail(f"the reduced granite fleet: card and CPU disagree: {runs}")
    if runs["cuda", 1]["tokens"] != card["tokens"]:
        fail("the reduced granite fleet's tokens differ from one engine's")
    per = [sum(1 for p in card["placements"] if p[1] == i) for i in (0, 1)]
    if min(per) == 0:
        fail(f"the reduced fleet used one replica: {per}")
    print(f"  reduced granite fleet (2 replicas, affinity): card == CPU "
          f"({len(card['tokens'])} requests, placements/replica {per}, "
          f"KV hits {card['kv_hits']}, fleet hit rate "
          f"{card['kv_hit_rate']:.4f}); fleet == one engine on the card",
          flush=True)
    return {"placements_per_replica": per, "kv_hits": card["kv_hits"],
            "kv_hit_rate": card["kv_hit_rate"],
            "requests": len(card["tokens"])}


def prom_values(text):
    """Prometheus text → {family: {replica label: value}}."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        series, val = line.rsplit(" ", 1)
        family, label = series.split("{", 1)
        out.setdefault(family, {})[label.split('"')[1]] = float(val)
    return out


def check_export(trace_path, prom_path, engines, router=None):
    """Parse a written Perfetto JSON and Prometheus text back: one phase
    process per replica with schedule, submit and retire tracks, the
    router's process exactly when a router ran, and the reused-token
    counter equal to the ledgers' reused sum and to the prefix caches'
    hits times the block size."""
    from repro_torch.obs.export import PID_LIFECYCLE, PID_PHASE, PID_ROUTER
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    procs = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e["name"] == "process_name"}
    threads = {}
    for e in events:
        if e.get("ph") == "M" and e["name"] == "thread_name":
            threads.setdefault(e["pid"], set()).add(e["args"]["name"])
    phase = {p for p in procs if PID_PHASE <= p < PID_LIFECYCLE}
    if phase != set(range(PID_PHASE, PID_PHASE + len(engines))):
        fail(f"{trace_path}: phase processes {sorted(phase)} for "
             f"{len(engines)} replicas")
    for p in phase:
        if not {"schedule", "submit", "retire"} <= threads.get(p, set()):
            fail(f"{trace_path}: process {procs[p]!r} lacks a phase track: "
                 f"{threads.get(p)}")
    if (PID_ROUTER in procs) != (router is not None):
        fail(f"{trace_path}: router process {PID_ROUTER in procs}, router "
             f"ran {router is not None}")
    prom = prom_values(Path(prom_path).read_text())
    reused = sum(prom["repro_tokens_reused_total"].values())
    ledger = sum(r[2] for e in engines for r in e.tracer.ledger)
    hits = sum(e.kv_mgr.hits for e in engines) * engines[0].ecfg.block_size
    if not reused == ledger == hits:
        fail(f"{prom_path}: repro_tokens_reused_total {reused}, ledger "
             f"{ledger}, kv hits x block size {hits}")
    if router is not None and prom["repro_placements_total"]["router"] \
            != len(router.placements):
        fail(f"{prom_path}: placements counter != the placements log")
    print(f"  export: {len(events)} Perfetto events in {len(procs)} "
          f"processes ({', '.join(sorted(procs.values()))}); "
          f"{len(prom)} counter families; repro_tokens_reused_total "
          f"{reused:g} = ledger = kv hits x block size", flush=True)
    return {"events": len(events), "processes": sorted(procs.values()),
            "counter_families": len(prom), "tokens_reused": reused}


def leak_check(engines, what):
    for e in engines:
        if e.kv_mgr.num_free() != e.kv_mgr.num_blocks \
                or any(m.ref for m in e.kv_mgr.meta):
            fail(f"{what}: KV blocks leaked after the drain")


def launcher_path(torch, cfg, params, adapters, prompt_len, tmp):
    """``repro_torch.launch.serve.serve`` at full width with the
    launcher's defaults but ``prompt_len`` (4 requests, gen 32, eval 16,
    one adapter, a warm-up pass and the measured pass for each of LoRA
    and aLoRA), every kernel count set to 0 just before and read just
    after: one B1 and one fused B2 call per layer and mixed step; every
    aLoRA eval reusing the base request's computed full blocks, every
    LoRA eval none; the final stage reusing the base request's blocks;
    the aLoRA run's trace and counters written and parsed back."""
    from repro_torch.launch import serve as S
    from repro_torch.models.layers import padded_vocab
    from repro_torch.serving import fmt_speedups, speedup_table
    gen_len, eval_len, final_len = 32, 16, 16
    paths = dict(trace_out=str(tmp / f"alora_p{prompt_len}.json"),
                 metrics_out=str(tmp / f"alora_p{prompt_len}.prom"))
    La = cfg.num_layers
    reset_counts()
    t0 = time.perf_counter()
    with mixed_steps() as steps:
        results = S.serve(cfg, params, adapters, prompt_len=prompt_len,
                          device="cuda", **paths)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(zip(SERVING, read_counts()))
    n = len(steps)
    want = dict(zip(SERVING, (La * n, 0, La * n, 0)))
    if counts != want:
        fail(f"launcher p{prompt_len}: launch counts {counts} != {want} for "
             f"{n} mixed steps of {La} layers")
    bs = 16
    # the base request computed K/V for its prompt and all but its last
    # generated token; its full blocks are what a later request can reuse
    reusable = (prompt_len + gen_len - 1) // bs * bs
    vpad = padded_vocab(cfg)
    out = {"prompt_len": prompt_len, "seconds": seconds, "steps": n,
           "launches": counts, "reusable_tokens": reusable}
    for kind in S.KINDS:
        eng, res = results[kind]
        stages = {}
        for stage, want_len in (("base", gen_len), ("eval", eval_len),
                                ("final", final_len)):
            ids = getattr(res, f"{stage}_ids")
            reqs = [eng.request(i) for i in ids]
            for r in reqs:
                if len(r.output_tokens) != want_len or not all(
                        0 <= t < vpad for t in r.output_tokens):
                    fail(f"launcher {kind} {stage} request {r.req_id}: "
                         f"{r.output_tokens}")
            m = res.stage_metrics(eng, stage)
            stages[stage] = {"hits": [r.n_cache_hit_tokens for r in reqs],
                             **{k: m.means[k] for k in (
                                 "queue", "prefill", "decode", "ttft",
                                 "e2e", "cache_hit_frac")},
                             "throughput_tok_per_s": m.throughput_tok_per_s}
            s = stages[stage]
            print(f"  {kind:5s} {stage:5s} p{prompt_len}: e2e "
                  f"{s['e2e'] * 1e3:.2f} ms, ttft {s['ttft'] * 1e3:.2f}, "
                  f"queue {s['queue'] * 1e3:.2f}, prefill "
                  f"{s['prefill'] * 1e3:.2f}, decode {s['decode'] * 1e3:.2f}"
                  f", reused tokens {s['hits']}", flush=True)
        ev, fin = stages["eval"]["hits"], stages["final"]["hits"]
        if kind == "alora" and min(ev) < reusable:
            fail(f"launcher p{prompt_len}: an aLoRA eval reused fewer than "
                 f"{reusable} tokens: {ev}")
        if kind == "lora" and any(ev):
            fail(f"launcher p{prompt_len}: a LoRA eval reused tokens: {ev}")
        # the final base request finds the base request's blocks unless
        # the evals' allocations evicted them from the pool (the LoRA
        # evals' own blocks at long prompts)
        evicted = eng.kv_mgr.evictions
        if (kind == "alora" or not evicted) and min(fin) < reusable:
            fail(f"launcher p{prompt_len} {kind}: a final request reused "
                 f"fewer than {reusable} tokens with {evicted} evictions: "
                 f"{fin}")
        if kind == "alora" and evicted:
            fail(f"launcher p{prompt_len}: the aLoRA leg evicted {evicted} "
                 "blocks")
        print(f"  {kind:5s} p{prompt_len}: {evicted} cached blocks evicted "
              "from the pool", flush=True)
        leak_check([eng], f"launcher {kind}")
        stages["evictions"] = evicted
        out[kind] = stages
    sp = speedup_table(
        results["lora"][1].stage_metrics(results["lora"][0], "eval"),
        results["alora"][1].stage_metrics(results["alora"][0], "eval"))
    out["eval_speedups"] = sp
    lora_rows = [(T, a) for r, T, a, _ in steps if r == 8 and a]
    out["lora_steps_all_128_rows_adapted"] = sum(
        1 for T, a in lora_rows if T == a == 128)
    out["lora_adapted_rows"] = sum(a for _, a in lora_rows)
    print(f"  p{prompt_len}: {n} mixed steps in {seconds:.1f} s (both legs, "
          f"warm-up passes included); launches "
          + ", ".join(f"{k} {v}" for k, v in counts.items())
          + f"; LoRA leg: {out['lora_steps_all_128_rows_adapted']} steps "
          f"with all 128 rows on the rank-8 slot, {out['lora_adapted_rows']}"
          f" adapted rows; eval speedups (LoRA / aLoRA) {fmt_speedups(sp)}",
          flush=True)
    out["export"] = check_export(paths["trace_out"], paths["metrics_out"],
                                 [results["alora"][0]])
    del results
    gc.collect()
    return out


def fleet_path(torch, cfg, params, gen, tmp):
    """Two replicas over the one set of weights on the card behind the
    router, on ``fleet_trace`` (``FLEET``) under ``affinity``, under
    ``round_robin`` and under ``affinity`` with replica 1 stopped mid-run
    (``FLEET_STOP``), every kernel count set to 0 just before each run
    and read just after.  Every replica's weights are the caller's
    tensors (the same ``data_ptr``); the second replica adds its pools,
    not a copy of the weights; under affinity every later turn lands on
    its previous turn's replica with a cached prefix; affinity's fleet
    hit rate is above round robin's; the drain loses no request and
    counts its re-routes; the fleet's trace and counters are written and
    parsed back."""
    from repro_torch.common import tree_leaves
    from repro_torch.core.alora import AdapterSpec, init_adapter_weights
    from repro_torch.launch.serve import collect_tracers
    from repro_torch.obs import prometheus_text, write_perfetto
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.serving.router import Router

    adapters = [(AdapterSpec(f"ad{i}", 32, INV),
                 init_adapter_weights(gen, cfg, 32, device="cuda"))
                for i in range(2)]
    ecfg = EngineConfig(adapter_slots=2)
    ptrs = [t.data_ptr() for t in tree_leaves(params)]
    La = cfg.num_layers
    torch.cuda.synchronize()
    mem = [torch.cuda.memory_allocated()]
    out = {}
    for name, policy, stop in (("affinity", "affinity", None),
                               ("round_robin", "round_robin", None),
                               ("drain", "affinity", FLEET_STOP)):
        engines = []
        for _ in range(2):
            engines.append(Engine(cfg, params, adapters=adapters,
                                  engine_cfg=ecfg, device="cuda"))
            torch.cuda.synchronize()
            if name == "affinity":
                mem.append(torch.cuda.memory_allocated())
        for e in engines:
            if [t.data_ptr() for t in tree_leaves(e.runner.params)] != ptrs:
                fail("a replica holds its own copy of the weights")
        router = Router(engines, policy=policy)
        step_ms = []
        orig = router.step

        def timed_step(orig=orig, step_ms=step_ms):
            t0 = time.perf_counter()
            r = orig()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return r

        router.step = timed_step
        reset_counts()
        t0 = time.perf_counter()
        with mixed_steps() as steps:
            gids, moved = fleet_trace(router, cfg, stop=stop, **FLEET)
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(zip(SERVING, read_counts()))
        want = dict(zip(SERVING, (La * len(steps), 0, La * len(steps), 0)))
        if counts != want:
            fail(f"fleet {name}: launch counts {counts} != {want}")
        leak_check(engines, f"fleet {name}")
        per = [sum(1 for p in router.placements if p.replica == i)
               for i in range(2)]
        agg = router.metrics_for(gids)
        r = out[name] = {
            "policy": policy, "requests": len(gids), "seconds": seconds,
            "mixed_steps": len(steps), "router_steps": len(step_ms),
            "router_step_ms_mean": statistics.mean(step_ms),
            "router_step_ms_median": statistics.median(step_ms),
            "placements_per_replica": per,
            "kv_hit_rate": router.kv_hit_rate(),
            "kv_hits": [e.kv_mgr.hits for e in engines],
            "throughput_tok_per_s": agg.throughput_tok_per_s,
            "tok_per_req_s": agg.tok_per_req_s,
            "launches": counts, "reroutes": router.reroutes}
        print(f"  fleet {name}: {len(gids)} requests, {len(step_ms)} router "
              f"steps, wall ms per router step mean "
              f"{r['router_step_ms_mean']:.2f} median "
              f"{r['router_step_ms_median']:.2f}; placements/replica {per}; "
              f"fleet kv_hit_rate {r['kv_hit_rate']:.4f} (hits "
              f"{r['kv_hits']}); merged throughput "
              f"{r['throughput_tok_per_s']:.1f} tok/s (virtual clock); "
              f"{seconds:.1f} s; launches " + ", ".join(
                  f"{k} {v}" for k, v in counts.items()), flush=True)
        if name == "affinity":
            n = FLEET["sessions"]
            pl = router.placements
            for i in range(n, len(pl)):
                if pl[i].replica != pl[i - n].replica \
                        or pl[i].cached_tokens <= 0:
                    fail(f"fleet affinity: turn {i // n} of session "
                         f"{i % n} left its replica or found no cached "
                         f"prefix: {pl[i - n]} -> {pl[i]}")
            tp, mp_ = tmp / "fleet.json", tmp / "fleet.prom"
            trs = collect_tracers(router)
            write_perfetto(str(tp), trs)
            mp_.write_text(prometheus_text(trs))
            r["export"] = check_export(tp, mp_, engines, router)
        if name == "drain":
            after = router.placements[(FLEET_STOP[0] + 1)
                                      * FLEET["sessions"]:]
            if not moved or router.reroutes != moved:
                fail(f"fleet drain: re-routed {moved}, reroutes "
                     f"{router.reroutes}")
            if any(p.replica == 1 for p in after) or not engines[1].idle:
                fail("fleet drain: work was placed on the stopped replica")
            r["rerouted"] = moved
            print(f"  fleet drain: stop_replica(1) re-routed {moved} queued "
                  f"requests, every request reached {FLEET['gen']} tokens",
                  flush=True)
        del router, engines, orig
        gc.collect()
    if not out["affinity"]["kv_hit_rate"] > out["round_robin"]["kv_hit_rate"]:
        fail(f"fleet: affinity's hit rate {out['affinity']['kv_hit_rate']} "
             f"is not above round robin's {out['round_robin']['kv_hit_rate']}")
    out["memory_gb"] = {"before": mem[0] / 1e9, "one_replica": mem[1] / 1e9,
                        "two_replicas": mem[2] / 1e9}
    added = [(b - a) / 1e9 for a, b in zip(mem, mem[1:])]
    weights_gb = sum(t.numel() * t.element_size()
                     for t in tree_leaves(params)) / 1e9
    if max(added) > weights_gb / 2:
        fail(f"a replica added {max(added):.2f} GB, a copy of the weights "
             f"({weights_gb:.2f} GB)")
    print(f"  memory_allocated: {mem[0] / 1e9:.3f} GB with the weights and "
          f"adapters, {mem[1] / 1e9:.3f} after 1 replica, {mem[2] / 1e9:.3f} "
          f"after 2 (each adds {added[0]:.3f} / {added[1]:.3f} GB: its pools;"
          f" the weights are {weights_gb:.2f} GB, shared)", flush=True)
    return out


def serving_tier(torch):
    """Phase 6: granite-3.2-8b at full width, random weights from a seed,
    one copy on the card: the launcher at each of ``LAUNCH_PROMPTS`` on
    its first ``LAUNCH_LAYERS`` layers, then the two-replica fleet on all
    40."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as S
    from repro_torch.models.model import init_params
    cfg = get_config("granite-3.2-8b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(gen, cfg, device="cuda")
    adapters = {kind: S.init_adapters(gen, cfg, kind, device="cuda")
                for kind in S.KINDS}
    out = {"launcher": {}, "launcher_layers": LAUNCH_LAYERS}
    lcfg = cfg.replace(num_layers=LAUNCH_LAYERS)
    lparams = {**params, "layers": params["layers"][:LAUNCH_LAYERS]}
    ladapters = {kind: S.init_adapters(gen, lcfg, kind, device="cuda")
                 for kind in S.KINDS}
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        for p in LAUNCH_PROMPTS:
            print(f" [6] launcher, --prompt-len {p}, {LAUNCH_LAYERS} layers",
                  flush=True)
            out["launcher"][p] = launcher_path(torch, lcfg, lparams,
                                               ladapters, p, tmp)
        del lparams, ladapters
        print(" [6] fleet of 2 replicas", flush=True)
        out["fleet"] = fleet_path(torch, cfg, params, gen, tmp)
    del params, adapters
    gc.collect()
    torch.cuda.empty_cache()
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


def analyzer(root):
    """Phase 1: the port's static analyzer (``python -m
    repro_torch.analysis --skip-audit``: the hot-path lint and the
    resource-lifecycle check, pure AST) over the checkout's tree; any
    violation fails.  Its step audit runs in phase 11."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--skip-audit",
                          "--out", str(root / "results" / "torch")],
                         cwd=root, env={**os.environ,
                                        "PYTHONPATH": str(root / "src")},
                         capture_output=True, text=True, timeout=300)
    print("  " + out.stdout.strip().replace("\n", "; ")
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    if out.returncode:
        fail(f"python -m repro_torch.analysis exited {out.returncode}:\n"
             + out.stderr)


# ---------------------------------------------------------------------------
# phase 7: the paper's benches and examples (repro_torch.benchmarks,
# repro_torch.examples)
# ---------------------------------------------------------------------------
# full-width sweep points: the reference's lists, cut to keep the phase
# near four minutes (PERF.md lists the cuts)
FULL_SWEEPS = dict(fig6=dict(prompt_lens=[384]),
                   fig11=dict(prompt_lens=[192]), fig15=dict(batches=[4]),
                   fig10=dict(gen_lens=[16]), fig8=dict(rates=[16.0]),
                   router=dict(fleet_sizes=(4,)))
# Zipf at full width: 128 registrations (a rank-32 granite adapter holds
# ~47 MB of pinned host memory; the reference's 1,000 would be ~47 GB)
# and 32 of the trace's 300 requests
ZIPF_FULL = dict(n_adapters=128, n_requests=32)
# (b) and (c) run granite-3.2-8b's widths at 10 of its 40 layers: the
# phase is host-bound (a mixed step's wall grows with its launches, about
# 25 per layer); at 40 layers it took 262-314 s of the smoke's time, at
# 20 112-194 s
PAPER_LAYERS = 10


def bench_legs(smoke: bool):
    """(name, arch, call) of every bench leg on the card: each bench's
    ``--smoke`` form, or its full form with the ``FULL_SWEEPS`` /
    ``ZIPF_FULL`` cuts."""
    from repro_torch.benchmarks import (bench_adapter_base, bench_async,
                                        bench_batch_size,
                                        bench_generation_length,
                                        bench_mixed_batch,
                                        bench_multi_adapter,
                                        bench_prompt_length, bench_router)
    g, m2 = "granite-3.2-8b", "mamba2-2.7b"
    kw = dict(smoke=smoke, device="cuda")
    sw = (lambda k: {}) if smoke else FULL_SWEEPS.get
    zipf = {} if smoke else ZIPF_FULL
    legs = [
        ("fig6", g, lambda: fig6_reuse(bench_prompt_length.run(
            **kw, **sw("fig6")))),
        ("fig11", g, lambda: bench_adapter_base.run(**kw, **sw("fig11"))),
        ("fig15", g, lambda: bench_batch_size.run(**kw, **sw("fig15"))),
        ("fig10", g, lambda: bench_generation_length.run(**kw,
                                                         **sw("fig10"))),
        ("fig8", g, lambda: bench_async.run(**kw, **sw("fig8"))),
        ("sec441", g, lambda: bench_multi_adapter.run(device="cuda")),
        ("churn", g, lambda: bench_multi_adapter.run_churn(**kw)),
        ("zipf", g, lambda: bench_multi_adapter.run_zipf(**kw, **zipf)),
        ("mixed_batch", g, lambda: bench_mixed_batch.run(
            **kw, async_leg=True, trace_check=True)),
        ("router", g, lambda: bench_router.run(**kw, **sw("router"))),
    ]
    if smoke:
        # the reference CI's SSM leg
        legs.append(("mixed_batch_mamba2", m2, lambda: bench_mixed_batch.run(
            m2, **kw)))
    return legs


def fig6_reuse(rows):
    """Fig. 6's evals: every aLoRA eval reuses prompt tokens of its base
    request, no LoRA eval reuses any."""
    for name, r in rows.items():
        if name.startswith("fig6/eval/"):
            alora = name.startswith("fig6/eval/alora/")
            print(f"    {name}: reused tokens {r['hits']}, hit fraction "
                  f"{r['hit']:.3f}", flush=True)
            if (min(r["hits"]) <= 0) if alora else any(r["hits"]):
                fail(f"{name}: reused tokens {r['hits']}")
    return rows


@contextlib.contextmanager
def logit_margin(torch):
    """The smallest top-1 minus top-2 logit of every row any step computes
    while the block runs (``out[0]``, a card tensor, read once at the
    end): where it is 0.0 the greedy token is a tie, and bf16 runs that
    differ only in rounding may pick either."""
    from repro_torch.models import model as M
    orig = M.logits_for
    out = [None]

    def margins(params, cfg, hidden):
        logits = orig(params, cfg, hidden)
        top = torch.topk(logits.float().reshape(-1, logits.shape[-1]), 2,
                         dim=-1).values
        m = (top[:, 0] - top[:, 1]).min()
        out[0] = m if out[0] is None else torch.minimum(out[0], m)
        return logits

    M.logits_for = margins
    try:
        yield out
    finally:
        M.logits_for = orig


@contextlib.contextmanager
def step_walls():
    """While the block runs: the wall time of every ``Engine.step`` that
    submitted a mixed step (``walls``; its length is the mixed steps
    taken) and the sequential mode's calls (``seq[0]``)."""
    from repro_torch.serving.engine import Engine
    orig = Engine.step
    walls, seq = [], [0]

    def timed(self):
        cc = self.runner.call_counts
        n0, s0 = cc["mixed_step"], cc["prefill_chunk"] + cc["decode_batch"]
        t0 = time.perf_counter()
        out = orig(self)
        if cc["mixed_step"] > n0:
            walls.append(time.perf_counter() - t0)
        seq[0] += cc["prefill_chunk"] + cc["decode_batch"] - s0
        return out

    Engine.step = timed
    try:
        yield walls, seq
    finally:
        Engine.step = orig


def run_leg(torch, name, cfg, call, tag):
    """One bench leg on the model of config ``cfg``, its launches counted:
    on every mixed step B1 and B2's fused entry launch once per attention
    layer, B3 once per SSM layer, and B2's one-pair entry once per SSM
    layer of a mixed step or a sequential call (checked here for every
    leg; the benches check the mixed steps of each measured pass)."""
    from repro_torch.configs.base import ATTN, SSM
    kinds = list(cfg.pattern())
    La, Ls = kinds.count(ATTN), kinds.count(SSM)
    before = dict(zip(SERVING, read_counts()))
    t0 = time.perf_counter()
    with step_walls() as (walls, seq), logit_margin(torch) as margin:
        rows = call()
        torch.cuda.synchronize()
    margin = float("nan") if margin[0] is None else float(margin[0])
    seconds = time.perf_counter() - t0
    got = {k: v - before[k] for k, v in zip(SERVING, read_counts())}
    n = len(walls)
    want = {"ragged_paged_attention": La * n, "ragged_grouped_lora_qkv":
            La * n, "ragged_grouped_lora": Ls * (n + seq[0]),
            "ragged_ssd_chunk_scan": Ls * n}
    if got != want or n == 0:
        fail(f"phase 7 {tag} {name}: launches {got} over {n} mixed steps, "
             f"expected {want}")
    ms = 1e3 * statistics.fmean(walls)
    print(f"  [7{tag}] {name}: {seconds:.1f} s wall, {n} mixed steps, "
          f"{ms:.2f} ms mean wall a mixed step, launches a step: "
          + ", ".join(f"{k} {v // n}" for k, v in got.items() if v)
          + f"; smallest top-1/top-2 logit margin {margin:.3e}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"seconds": seconds, "mixed_steps": n, "step_wall_ms": ms,
            "sequential_calls": seq[0], "min_top2_logit_margin": margin,
            "launches": got,
            # a bench's CSV rows (an example returns no rows)
            "rows": {k: {"us": r["us"], "derived": r["derived"]}
                     for k, r in rows.items()} if isinstance(rows, dict)
            and all(isinstance(r, dict) and "us" in r for r in rows.values())
            else {}}


def full_width_adapters(torch, cfg):
    """Adapter ``i`` at ``rank`` of full width, drawn anew from seed
    100 + i on the card at every registration."""
    from repro_torch.core.alora import init_adapter_weights

    def weights(rank, i):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        return init_adapter_weights(gen, cfg, rank, device="cuda")
    return weights


def paper_benches(torch):
    """Phase 7: (a) every bench's ``--smoke`` leg on the reduced float32
    models, with every reference assert; (b) every bench at full width on
    granite-3.2-8b in bf16 (random weights from a seed, one copy on the
    card), one warm-up and one measured pass each; (c) the three examples
    on the same weights.  (b) and (c) keep granite's widths at
    ``PAPER_LAYERS`` layers."""
    from repro_torch.benchmarks import common
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.examples import async_poisson, quickstart, \
        serve_multiturn
    from repro_torch.models.model import init_params
    out = {"smoke": {}, "full": {}, "examples": {}}
    print(" [7a] every bench's --smoke leg, reduced float32 models",
          flush=True)
    for name, arch, call in bench_legs(smoke=True):
        out["smoke"][name] = run_leg(torch, name, get_reduced(arch), call,
                                     "a")
    common.uninstall()

    cfg = get_config("granite-3.2-8b").replace(num_layers=PAPER_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(gen, cfg, device="cuda")
    adapters = full_width_adapters(torch, cfg)
    common.install("granite-3.2-8b", cfg, params, adapters)
    print(" [7b] every bench at full width, granite-3.2-8b bf16 at "
          f"{PAPER_LAYERS} layers (cuts: {FULL_SWEEPS}, zipf {ZIPF_FULL})",
          flush=True)
    for name, _, call in bench_legs(smoke=False):
        out["full"][name] = run_leg(torch, name, cfg, call, "b")
    common.uninstall()

    print(" [7c] the examples at full width", flush=True)
    model = (cfg, params, lambda rank: adapters(rank, 0))
    for ex in (quickstart, serve_multiturn, async_poisson):
        name = ex.__name__.rsplit(".", 1)[-1]
        out["examples"][name] = run_leg(
            torch, name, cfg, lambda: ex.main(device="cuda", model=model),
            "c")
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    out["full_sweeps"] = FULL_SWEEPS
    out["zipf_full"] = ZIPF_FULL
    out["layers"] = PAPER_LAYERS
    return out


# ---------------------------------------------------------------------------
# phase 8: the full-sequence model and training (repro_torch.models.model's
# forward_full / decode_step, repro_torch.training)
# ---------------------------------------------------------------------------
GRANITE_FULL = dict(B=2, S=1024, act=512, decode=16, rank=32, adapters=4)
# granite's first decode_step against forward_full in bf16 at 40 layers,
# a fixed limit of max |forward_full|: sound decoding reads 4.62e-2, the
# bf16 rounding floor of the same forward (row 0 alone vs in the batch)
# 4.05e-2 (PERF.md, section 6); a wrong position or cache is off by O(1).
# The float32 check at granite's widths x 4 layers (TOL) is the tight one.
GRANITE_BF16_DECODE_TOL = 6e-2
MAMBA_FULL = dict(B=2, S=2048, grad_S=512)
TRAIN_FULL = dict(layers=16, B=4, S=1024, steps=10, mem_layers=2)
PARITY_FULL = ("granite-3.2-8b", "mamba2-2.7b", "zamba2-2.7b",
               "whisper-large-v3", "granite-moe-1b-a400m",
               "phi-3-vision-4.2b", "starcoder2-3b")


def wall_ms(torch, fn, n: int = 1) -> float:
    """Host ms per call of ``fn`` over ``n`` calls ending in a
    synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def param_bytes(torch, tree) -> int:
    from repro_torch.common import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def check_full_b6(torch, timer):
    """B6 (the fused aLoRA projection) at the full-sequence model's shapes
    on granite-3.2-8b (bf16, four rank-32 adapters beside the zero slot):
    ``forward_full``'s T = B * S = 2,048 rows and ``decode_step``'s T = 2,
    for the Q (4096 -> 4096) and K/V (4096 -> 1024) widths, against
    ``alora_qkv_ref`` with NaN in slot 0's A and B (the kernel and the
    plain version skip it), timed beside the bound and the base GEMM."""
    from repro_torch.kernels import alora_qkv, bench
    gen = torch.Generator(device="cuda").manual_seed(8)
    dt, tol = torch.bfloat16, TOL["bfloat16"]
    res = {}
    for T in (2048, 2):
        for proj, out in (("q", 4096), ("kv", 1024)):
            case = bench.alora_case(gen, "cuda", dt, T=T, d=4096, out=out,
                                    n=5, r=32, name=f"granite_{proj}_T{T}")
            x, w, a, b, idx = case.args
            a[0] = float("nan")
            b[0] = float("nan")
            got = alora_qkv.alora_qkv(*case.args)
            want = alora_qkv.alora_qkv_ref(*case.args)
            torch.cuda.synchronize()
            r = bench.errors(got, want, False)
            key = f"alora_qkv/{case.name}"
            if not r["finite"] or r["rel_err"] > tol:
                fail(f"{key}: finite {r['finite']}, {r['rel_err']} of "
                     f"max|plain| > {tol}")
            p = alora_qkv.plan(T, 4096, out, 32, 5, dt)
            r.update(shape=case.shape, dtype="bfloat16", tol=tol,
                     ms=timer(lambda: alora_qkv.alora_qkv(*case.args)),
                     plain_ms=timer(lambda: alora_qkv.alora_qkv_ref(
                         *case.args)),
                     base_gemm_ms=timer(lambda: torch.matmul(x, w)),
                     library_ms=None, tiles=[p.bm, p.bn], grid=list(p.grid))
            r["bound_ms"], r["bound_by"] = bench.bound_ms(case.nbytes,
                                                          case.ops, dt)
            res[key] = r
            print(f"  {key} ({case.shape}, NaN in slot 0): "
                  f"{r['rel_err']:.3e} of max|plain| (tol {tol}); kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, base "
                  f"GEMM {r['base_gemm_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']}); tiles "
                  f"{p.bm} x {p.bn}, grid {p.grid}", flush=True)
            del case, got, want, x, w, a, b, idx
    return res


def full_granite(torch):
    """granite-3.2-8b at full width and depth (bf16, random weights from a
    seed, four rank-32 aLoRA adapters): ``forward_full`` on B = 2 rows of
    1,024 tokens with caches, row 0 on the base weights and row 1 on
    adapter 1 from token 512 (B6 exactly 3 x 40 times; row 0 equal to the
    adapter-free forward within bf16 tolerance), then
    ``prefill_to_decode_caches`` and 16 ``decode_step``s (B6 120 times a
    step; the first step's logits equal ``forward_full``'s over the
    prefix and that token within ``GRANITE_BF16_DECODE_TOL``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.alora import init_adapter_weights, stack_adapters
    from repro_torch.kernels.alora_qkv import alora_qkv
    from repro_torch.models import model as M
    g = GRANITE_FULL
    cfg = get_config("granite-3.2-8b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(gen, cfg, device="cuda")
    st = stack_adapters(cfg, [init_adapter_weights(gen, cfg, g["rank"],
                                                   device="cuda")
                              for _ in range(g["adapters"])], g["rank"])
    B, S, nd = g["B"], g["S"], g["decode"]
    toks = torch.randint(10, cfg.vocab_size, (B, S + nd), generator=gen,
                         device="cuda")
    aidx = torch.zeros((B, S + nd), dtype=torch.int32, device="cuda")
    aidx[1, g["act"]:] = 1
    La = cfg.num_layers
    out = {"B": B, "S": S, "layers": La, "adapters": g["adapters"],
           "rank": g["rank"]}
    with torch.no_grad():
        def fwd():
            return M.forward_full(params, cfg, toks[:, :S], adapters=st,
                                  adapter_idx=aidx[:, :S],
                                  return_caches=True)
        h, _, caches = fwd()                      # warm-up (plans, cuBLAS)
        torch.cuda.synchronize()
        alora_qkv.launches = 0
        out["forward_ms"] = wall_ms(torch, fwd, 2)
        out["forward_launches_B6"] = alora_qkv.launches / 2
        if out["forward_launches_B6"] != 3 * La:
            fail(f"granite forward_full: B6 launched "
                 f"{out['forward_launches_B6']} times, not {3 * La}")
        h0, _, _ = M.forward_full(params, cfg, toks[:, :S])
        out["row0_rel_err"] = rel_err(h[0], h0[0])[1]
        if out["row0_rel_err"] > TOL["bfloat16"]:
            fail(f"granite forward_full: row 0 (base weights) differs from "
                 f"the adapter-free forward by {out['row0_rel_err']}")
        out["row1_differs"] = rel_err(h[1], h0[1])[1]
        del h0
        dc = M.prefill_to_decode_caches(cfg, caches, S, S + nd)
        del caches, h
        tok = toks[:, S:S + 1]
        alora_qkv.launches = 0
        steps_ms, first = [], None
        for i in range(nd):
            t0 = time.perf_counter()
            lg, dc = M.decode_step(params, cfg, tok, dc, S + i, adapters=st,
                                   adapter_idx=aidx[:, S + i:S + i + 1])
            torch.cuda.synchronize()
            steps_ms.append((time.perf_counter() - t0) * 1e3)
            if first is None:
                first = lg[:, 0].float()
            tok = lg[:, 0].argmax(-1, keepdim=True)
        out["decode_launches_B6_per_step"] = alora_qkv.launches / nd
        if alora_qkv.launches != 3 * La * nd:
            fail(f"granite decode_step: B6 launched {alora_qkv.launches} "
                 f"times in {nd} steps, not {3 * La * nd}")
        out["decode_ms"] = statistics.median(steps_ms[1:])
        hf, _, _ = M.forward_full(params, cfg, toks[:, :S + 1], adapters=st,
                                  adapter_idx=aidx[:, :S + 1])
        want = M.logits_for(params, cfg, hf[:, -1]).float()
        # the bf16 rounding floor of these logits: the same forward on row
        # 0 alone (other GEMM shapes, the same math)
        h1, _, _ = M.forward_full(params, cfg, toks[:1, :S + 1],
                                  adapters=st, adapter_idx=aidx[:1, :S + 1])
        alone = M.logits_for(params, cfg, h1[:, -1]).float()
        out["bf16_floor_rel_err"] = rel_err(alone, want[:1])[1]
        out["decode_logits_rel_err"] = rel_err(first, want)[1]
        out["decode_logits_tol"] = GRANITE_BF16_DECODE_TOL
        del hf, h1
        if out["decode_logits_rel_err"] > GRANITE_BF16_DECODE_TOL:
            fail(f"granite decode_step: the first step's logits differ from "
                 f"forward_full's by {out['decode_logits_rel_err']} > "
                 f"{GRANITE_BF16_DECODE_TOL} (bf16 floor "
                 f"{out['bf16_floor_rel_err']})")
    nbytes = param_bytes(torch, params)
    out["weight_bytes"] = nbytes
    out["decode_weight_read_bound_ms"] = bound(nbytes, 0, "bfloat16")[0]
    out["forward_bound_ms"], out["forward_bound_by"] = bound(
        nbytes, 2 * (nbytes / 2) * B * S, "bfloat16")
    print(f"  granite-3.2-8b forward_full (B {B}, S {S}, {La} layers, "
          f"{g['adapters']} rank-{g['rank']} adapters): "
          f"{out['forward_ms']:.1f} ms (bound {out['forward_bound_ms']:.2f} "
          f"ms, {out['forward_bound_by']}); B6 {out['forward_launches_B6']:.0f}"
          f" launches; row 0 vs adapter-free {out['row0_rel_err']:.3e}, row 1"
          f" {out['row1_differs']:.3e}", flush=True)
    print(f"  decode_step (B {B}): median {out['decode_ms']:.2f} ms a step "
          f"(weight-read bound {out['decode_weight_read_bound_ms']:.2f} ms); "
          f"B6 {out['decode_launches_B6_per_step']:.0f} a step; first step "
          f"vs forward_full {out['decode_logits_rel_err']:.3e} (tol "
          f"{GRANITE_BF16_DECODE_TOL}; bf16 floor: "
          f"row 0 alone vs in the batch {out['bf16_floor_rel_err']:.3e})",
          flush=True)
    del params, st, dc
    gc.collect()
    torch.cuda.empty_cache()
    out["float32"] = granite_f32_decode(torch)
    return out


def granite_f32_decode(torch, layers: int = 4):
    """The same prefill -> decode_step against forward_full at granite's
    full widths in float32 (``layers`` layers, no adapter): within TOL of
    max |forward_full| (bf16 at 40 layers is held to
    ``GRANITE_BF16_DECODE_TOL``, above its rounding floor)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    B, S = GRANITE_FULL["B"], GRANITE_FULL["S"]
    cfg = get_config("granite-3.2-8b").replace(num_layers=layers,
                                               dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(gen, cfg, device="cuda")
    toks = torch.randint(10, cfg.vocab_size, (B, S + 1), generator=gen,
                         device="cuda")
    with torch.no_grad():
        _, _, c = M.forward_full(params, cfg, toks[:, :S],
                                 return_caches=True)
        dc = M.prefill_to_decode_caches(cfg, c, S, S + 1)
        lg, _ = M.decode_step(params, cfg, toks[:, S:], dc, S)
        hf, _, _ = M.forward_full(params, cfg, toks)
        err = rel_err(lg[:, 0], M.logits_for(params, cfg, hf[:, -1]))[1]
    if err > TOL["float32"]:
        fail(f"granite float32 ({layers} layers) decode_step vs "
             f"forward_full: {err} > {TOL['float32']}")
    print(f"  granite-3.2-8b widths, float32, {layers} layers: decode_step "
          f"vs forward_full {err:.3e} (tol {TOL['float32']})", flush=True)
    del params, c, dc, hf
    torch.cuda.empty_cache()
    return {"layers": layers, "decode_logits_rel_err": err}


@contextlib.contextmanager
def plain_ssm_scan(torch):
    """Every ``ssd_forward`` of the block runs the chunked plain scan."""
    from repro_torch.models import ssm
    real = ssm.dense_scan_applies
    ssm.dense_scan_applies = lambda *a: False
    try:
        yield
    finally:
        ssm.dense_scan_applies = real


@contextlib.contextmanager
def first_call(module, name, n: int = 1):
    """While the block runs, ``module.<name>`` keeps copies of the
    arguments of its first ``n`` calls (the yielded list) and passes
    every call on."""
    real, seen = getattr(module, name), []

    def recorded(*args):
        if len(seen) < n:
            seen.append(tuple(a.clone() for a in args))
        return real(*args)
    setattr(module, name, recorded)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def full_mamba2(torch, timer):
    """mamba2-2.7b at full width and depth (bf16, random weights): a no-grad
    ``forward_full`` on B = 2 rows of 2,048 tokens launches B5 once per
    layer (64) at the kernel bench's shape; layer 0's scan inputs from that
    run through B5 and through the chunked plain scan within 1e-4 of max
    |plain|, with both times; the final hidden state against the all-plain
    forward; B2 on an adapted forward (``mamba2_adapted``); then one
    ``forward_full`` under grad launches B5 zero times."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import bench
    from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
    from repro_torch.models import model as M
    from repro_torch.models import ssm
    m = MAMBA_FULL
    cfg = get_config("mamba2-2.7b")
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = M.init_params(gen, cfg, device="cuda")
    B, S = m["B"], m["S"]
    toks = torch.randint(10, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda")
    out = {"B": B, "S": S, "layers": cfg.num_layers}
    real = ssd_chunk_scan
    with torch.no_grad():
        M.forward_full(params, cfg, toks)          # warm-up
        ssd_chunk_scan.launches = 0
        with first_call(ssm, "ssd_chunk_scan") as seen:
            t0 = time.perf_counter()
            h, _, _ = M.forward_full(params, cfg, toks)
            torch.cuda.synchronize()
            out["forward_ms"] = (time.perf_counter() - t0) * 1e3
        out["forward_launches_B5"] = ssd_chunk_scan.launches
        if ssd_chunk_scan.launches != cfg.num_layers:
            fail(f"mamba2 forward_full: B5 launched {ssd_chunk_scan.launches}"
                 f" times, not {cfg.num_layers}")
        args = seen[0]
        out["scan_shape"] = f"{tuple(args[0].shape)} N={args[1].shape[-1]}"
        if args[0].shape != (B, S, 80, 64) or args[1].shape[-1] != 128:
            fail(f"mamba2 forward_full: B5 at {out['scan_shape']}, not the "
                 "bench's (2, 2048, 80, 64) N=128")
        Q = min(cfg.ssm.chunk_size, S)
        y, st = real(*args)
        yp, sp, _ = ssm.chunked_scan(*args, Q)
        torch.cuda.synchronize()
        out["layer0_rel_err_y"] = rel_err(y, yp)[1]
        out["layer0_rel_err_state"] = rel_err(st, sp)[1]
        if max(out["layer0_rel_err_y"], out["layer0_rel_err_state"]) > \
                TOL["float32"]:
            fail(f"mamba2 layer 0: B5 vs the chunked plain scan "
                 f"{out['layer0_rel_err_y']}, "
                 f"{out['layer0_rel_err_state']} > {TOL['float32']}")
        out["layer0_ms"] = timer(lambda: real(*args))
        out["layer0_plain_ms"] = timer(lambda: ssm.chunked_scan(*args, Q))
        Bt, _, H, P = args[0].shape
        N = args[1].shape[-1]
        nbytes = 4 * (2 * Bt * S * H * P + 2 * Bt * S * H * N
                      + 2 * Bt * S * H + Bt * H * N * P)
        out["layer0_bound_ms"], out["layer0_bound_by"] = bound(
            nbytes, Bt * H * bench.ssd_ops(S, N, P), "float32")
        with plain_ssm_scan(torch):
            ssd_chunk_scan.launches = 0
            hp, _, _ = M.forward_full(params, cfg, toks)
            if ssd_chunk_scan.launches:
                fail("mamba2: the all-plain forward launched B5")
        out["hidden_max_abs_err_vs_plain"], out["hidden_rel_err_vs_plain"], _ \
            = rel_err(h.float().reshape(B * S, -1),
                      hp.float().reshape(B * S, -1))
        del hp, seen, args
        out["adapted"] = mamba2_adapted(torch, timer, cfg, params, toks, h)
        del h
    leaves = [t for lp in params["layers"] for t in lp["ssm"].values()]
    for t in leaves:
        t.requires_grad_(True)
    ssd_chunk_scan.launches = 0
    hg, _, _ = M.forward_full(params, cfg, toks[:, :m["grad_S"]])
    out["grad_forward_launches_B5"] = ssd_chunk_scan.launches
    if ssd_chunk_scan.launches or not hg.requires_grad:
        fail(f"mamba2 forward_full under grad: B5 launched "
             f"{ssd_chunk_scan.launches} times")
    del hg
    for t in leaves:
        t.requires_grad_(False)
    print(f"  mamba2-2.7b forward_full (B {B}, S {S}, {cfg.num_layers} "
          f"layers): {out['forward_ms']:.1f} ms; B5 "
          f"{out['forward_launches_B5']} launches at {out['scan_shape']}; "
          f"layer 0 B5 vs chunked plain scan y {out['layer0_rel_err_y']:.3e}"
          f", state {out['layer0_rel_err_state']:.3e} (tol "
          f"{TOL['float32']}), B5 {out['layer0_ms']:.4f} ms, chunked plain "
          f"{out['layer0_plain_ms']:.4f} ms, bound "
          f"{out['layer0_bound_ms']:.4f} ms ({out['layer0_bound_by']}); "
          f"final hidden vs all-plain forward max |err| "
          f"{out['hidden_max_abs_err_vs_plain']:.3e} "
          f"({out['hidden_rel_err_vs_plain']:.3e} of max); under grad (S "
          f"{m['grad_S']}): B5 {out['grad_forward_launches_B5']} launches",
          flush=True)
    del params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mamba2_adapted(torch, timer, cfg, params, toks, h):
    """B2's one-pair entry on the full-sequence path: a no-grad
    ``forward_full`` of mamba2-2.7b with one rank-32 adapter, row 0 on the
    base weights and row 1 on the adapter from the middle of the
    sequence, launches B2 once per SSM layer (64) at T = B * S rows; layer
    0's delta inputs from that run through B2 and through
    ``ragged_grouped_lora_ref`` within bf16 tolerance, timed; row 0 of the
    hidden state against the adapter-free forward's ``h``."""
    from repro_torch.core.alora import init_adapter_weights, stack_adapters
    from repro_torch.kernels.ragged_lora import ragged_grouped_lora
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    B, S = toks.shape
    gen = torch.Generator(device="cuda").manual_seed(4)
    st = stack_adapters(cfg, [init_adapter_weights(gen, cfg, 32,
                                                   device="cuda")], 32)
    aidx = torch.zeros((B, S), dtype=torch.int32, device="cuda")
    aidx[1, S // 2:] = 1
    real = ragged_grouped_lora

    def fwd():
        return M.forward_full(params, cfg, toks, adapters=st,
                              adapter_idx=aidx)[0]
    fwd()                                          # warm-up
    ragged_grouped_lora.launches = 0
    with first_call(L, "ragged_grouped_lora") as seen:
        t0 = time.perf_counter()
        ha = fwd()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    out = {"forward_ms": ms, "launches_B2": ragged_grouped_lora.launches}
    if ragged_grouped_lora.launches != cfg.num_layers:
        fail(f"mamba2 adapted forward_full: B2 launched "
             f"{ragged_grouped_lora.launches} times, not {cfg.num_layers}")
    x, a, b, idx, act = seen[0]
    out["shape"] = (f"T={x.shape[0]} d={x.shape[1]} out={b.shape[-1]} "
                    f"n={a.shape[0]} r={a.shape[-1]}")
    if x.shape[0] != B * S:
        fail(f"mamba2 adapted forward_full: B2 at {out['shape']}, not "
             f"T = {B * S}")
    got, want = (real(x, a, b, idx, act),), lora_plain(x, [(a, b)], idx, act)
    torch.cuda.synchronize()
    out["max_abs_err"], out["rel_err"], out["row_rel_err"] = lora_errors(
        got, want)
    out["tol"] = TOL["bfloat16"]
    if out["rel_err"] > TOL["bfloat16"]:
        fail(f"mamba2 layer 0: B2 vs ragged_grouped_lora_ref "
             f"{out['rel_err']} > {TOL['bfloat16']}")
    if bool(got[0][idx == 0].float().abs().max() != 0):
        fail("mamba2 layer 0: B2 gave slot 0's rows a delta")
    t = time_lora(timer, x, [(a, b)], idx, act, "bfloat16")
    out.update({k: v for k, v in t.items() if k not in ("bytes", "ops")})
    out["row0_rel_err"] = rel_err(ha[0], h[0])[1]
    out["row1_differs"] = rel_err(ha[1], h[1])[1]
    if out["row0_rel_err"] > TOL["bfloat16"]:
        fail(f"mamba2 adapted forward_full: row 0 (base weights) differs "
             f"from the adapter-free forward by {out['row0_rel_err']}")
    print(f"  mamba2-2.7b adapted forward_full (row 1 on a rank-32 adapter "
          f"from token {S // 2}): {ms:.1f} ms; B2 {out['launches_B2']} "
          f"launches at {out['shape']}; layer 0 B2 vs plain "
          f"{out['rel_err']:.3e} of max|plain| (tol {TOL['bfloat16']}), "
          f"kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
          f"bound {out['bound_ms']:.5f} ms ({out['bound_by']}); row 0 vs "
          f"adapter-free {out['row0_rel_err']:.3e}, row 1 "
          f"{out['row1_differs']:.3e}", flush=True)
    del st, ha, seen, got, want
    return out


def full_training(torch):
    """Training at granite-3.2-8b's widths and 16 of its 40 layers (bf16
    params and grads, float32 moments): B = 4 rows of 1,024 tokens, remat
    and flash_remat on, ten AdamW steps on the reference's
    ``SyntheticDataset`` repeating one batch: every loss finite and the
    mean of the last three below the first three's; ms a step, tokens/s
    and peak memory.  Then at 2 layers one step each with flash_remat off
    and on (remat off), peak memory beside each."""
    from repro_torch.common import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.training import (AdamWConfig, DataConfig,
                                      SyntheticDataset, init_train_state,
                                      make_train_step)
    t = TRAIN_FULL
    out = {"layers": t["layers"], "B": t["B"], "S": t["S"],
           "steps": t["steps"]}
    # the reference launcher's schedule (lr 3e-4, 20 warm-up steps); two
    # warm-up steps overshoot at these widths (PERF.md, section 6)
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=t["steps"])

    def model(layers):
        cfg = get_config("granite-3.2-8b").replace(num_layers=layers)
        gen = torch.Generator(device="cuda").manual_seed(3)
        return cfg, M.init_params(gen, cfg, device="cuda")
    cfg, params = model(t["layers"])
    out["params"] = sum(x.numel() for x in tree_leaves(params))
    batch = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=t["S"],
                                        global_batch=t["B"])).batch(0)
    step = make_train_step(cfg, ocfg, M.Runtime(remat=True,
                                                flash_remat=True))
    state = init_train_state(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(t["steps"]):
        t0 = time.perf_counter()
        state, stats = step(state, batch)
        losses.append(float(stats["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    out["losses"] = losses
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["step_ms"] = statistics.median(ms[1:])
    out["tokens_per_s"] = t["B"] * t["S"] / (out["step_ms"] / 1e3)
    if not all(np.isfinite(losses)):
        fail(f"training: non-finite loss {losses}")
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    if not last < first:
        fail(f"training: the loss did not fall on a repeated batch: "
             f"{losses}")
    print(f"  training granite-3.2-8b widths, {t['layers']} layers "
          f"({out['params'] / 1e9:.3f} B params), B {t['B']}, S {t['S']}, "
          f"remat + flash_remat: losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; median {out['step_ms']:.1f} ms a step, "
          f"{out['tokens_per_s']:.0f} tokens/s, peak "
          f"{out['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    del state, params, step, stats
    gc.collect()
    torch.cuda.empty_cache()
    out["flash_remat_peak_bytes"] = {}
    for flash in (False, True):
        cfg, params = model(t["mem_layers"])
        step = make_train_step(cfg, ocfg, M.Runtime(flash_remat=flash))
        state = init_train_state(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, stats = step(state, batch)
        if not np.isfinite(float(stats["loss"])):
            fail("training at 2 layers: non-finite loss")
        out["flash_remat_peak_bytes"][str(flash).lower()] = \
            torch.cuda.max_memory_allocated()
        del state, params, step, stats
        gc.collect()
        torch.cuda.empty_cache()
    pk = out["flash_remat_peak_bytes"]
    print(f"  {t['mem_layers']} layers, one step, peak memory: flash_remat "
          f"off {pk['false'] / 2**30:.2f} GiB, on {pk['true'] / 2**30:.2f} "
          "GiB", flush=True)
    return out


def reduced_full_parity(torch, arch):
    """The reduced float32 ``arch`` on the card and on the CPU with the
    same weights and inputs (half of each row on an adapter): forward_full
    hidden within 1e-5 of max |CPU|, 16 greedy decode_step tokens
    identical (with the logits' smallest top-1/top-2 margin), and one
    train step's loss, ce, aux, grad norm and params within 1e-5
    relative.  starcoder2 runs 150 tokens past its 128-token window."""
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.configs import get_reduced
    from repro_torch.core.alora import init_adapter_weights, stack_adapters
    from repro_torch.models import model as M
    from repro_torch.training import (AdamWConfig, init_train_state,
                                      make_train_step)
    cfg = get_reduced(arch)
    gen = torch.Generator().manual_seed(5)
    params = M.init_params(gen, cfg, device="cpu")
    st = stack_adapters(cfg, [init_adapter_weights(gen, cfg, 8,
                                                   device="cpu")], 8)
    B, S = 2, 150 if arch == "starcoder2-3b" else 40
    rng = np.random.RandomState(6)
    toks = torch.from_numpy(rng.randint(10, cfg.vocab_size, (B, S)))
    aidx = torch.zeros((B, S), dtype=torch.int32)
    aidx[1, S // 2:] = 1
    n = {"audio": cfg.encoder_seq_len, "vision": cfg.num_patches}.get(
        cfg.frontend)
    extra = None if n is None else torch.from_numpy(
        (rng.randn(B, n, cfg.d_model) * 0.05).astype(np.float32))
    npre = S + (cfg.num_patches if cfg.frontend == "vision" else 0)
    batch = {"tokens": toks.numpy(), "labels": np.roll(toks.numpy(), -1, 1),
             "mask": np.ones((B, S), np.float32)}
    if extra is not None:
        batch["extra_embeds"] = extra.numpy()
    runs = {}
    for dev in ("cuda", "cpu"):
        on = lambda t: None if t is None else t.to(dev)  # noqa: E731
        p = tree_map(lambda t: t.to(dev), params)
        a = tree_map(lambda t: t.to(dev), st)
        with torch.no_grad():
            h, aux, caches = M.forward_full(
                p, cfg, on(toks), extra_embeds=on(extra), adapters=a,
                adapter_idx=on(aidx), return_caches=True)
            dc = M.prefill_to_decode_caches(cfg, caches, npre, npre + 16)
            tok = M.logits_for(p, cfg, h[:, -1:]).argmax(-1)
            out_toks, margin = [], float("inf")
            for i in range(16):
                lg, dc = M.decode_step(p, cfg, tok, dc, npre + i,
                                       adapters=a,
                                       adapter_idx=on(aidx[:, -1:]))
                margin = min(margin, top2_margin(torch, lg[:, 0]))
                tok = lg[:, 0].argmax(-1, keepdim=True)
                out_toks.append(tok[:, 0].tolist())
        ts, stats = make_train_step(cfg, AdamWConfig(total_steps=10),
                                    M.Runtime(), loss_chunk=16)(
            init_train_state(tree_map(lambda t: t.clone(), p)), batch)
        runs[dev] = dict(h=h.cpu(), aux=float(aux), tokens=out_toks,
                         margin=margin,
                         stats={k: float(v) for k, v in stats.items()},
                         params=[t.cpu() for t in tree_leaves(ts.params)])
    c, r = runs["cuda"], runs["cpu"]
    res = {"hidden_rel_err": rel_err(c["h"].reshape(-1, cfg.d_model),
                                     r["h"].reshape(-1, cfg.d_model))[1],
           "min_top2_logit_margin": {"cuda": c["margin"],
                                     "cpu": r["margin"]},
           "tokens_equal": c["tokens"] == r["tokens"]}
    if res["hidden_rel_err"] > 1e-5:
        fail(f"{arch} forward_full: card vs CPU {res['hidden_rel_err']}")
    if not res["tokens_equal"]:
        fail(f"{arch} decode_step: card tokens {c['tokens']} vs CPU "
             f"{r['tokens']}")
    res["train_rel_err"] = {
        k: abs(c["stats"][k] - r["stats"][k]) / max(abs(r["stats"][k]), 1e-6)
        for k in ("loss", "ce", "aux", "grad_norm", "lr")}
    scale = max(float(t.abs().max()) for t in r["params"])
    res["train_params_err"] = max(float((a - b).abs().max())
                                  for a, b in zip(c["params"],
                                                  r["params"])) / scale
    worst = max(max(res["train_rel_err"].values()), res["train_params_err"])
    if worst > 1e-5:
        fail(f"{arch} train step: card vs CPU {res['train_rel_err']}, "
             f"params {res['train_params_err']}")
    print(f"  {cfg.name}: forward_full card vs CPU "
          f"{res['hidden_rel_err']:.3e}; 16 decode tokens equal (smallest "
          f"top-1/top-2 margin card {c['margin']:.3e}, CPU "
          f"{r['margin']:.3e}); train step worst {worst:.3e}", flush=True)
    return res


def reduced_quant_and_engine(torch):
    """The reduced float32 granite: the prompt then 16 greedy
    ``decode_step`` tokens with int8 caches (``kv_cache_quant``, from
    ``init_decode_caches``) identical on the card and on the CPU; then the card's engine emits the port's own forward_full ->
    decode_step greedy tokens (the reference's
    ``test_engine_matches_dense_reference``)."""
    from repro_torch.common import tree_map
    from repro_torch.configs import get_reduced
    from repro_torch.core.alora import AdapterSpec, init_adapter_weights
    from repro_torch.models import model as M
    from repro_torch.serving import Engine
    cfg = get_reduced("granite-3.2-8b")
    gen = torch.Generator().manual_seed(7)
    params = M.init_params(gen, cfg, device="cpu")
    prompt = list(np.random.RandomState(0).randint(10, 500, 50))
    rt = M.Runtime(kv_cache_quant=True)
    toks, margins = {}, {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev), params)
        with torch.no_grad():
            dc = M.init_decode_caches(cfg, 1, 80, rt, device=dev)
            for i, t in enumerate(prompt):
                lg, dc = M.decode_step(
                    p, cfg, torch.tensor([[t]], device=dev), dc, i, rt)
            out, margin = [], float("inf")
            for i in range(16):
                margin = min(margin, top2_margin(torch, lg[:, 0]))
                tok = lg[:, 0].argmax(-1, keepdim=True)
                out.append(int(tok))
                lg, dc = M.decode_step(p, cfg, tok, dc, len(prompt) + i, rt)
        toks[dev], margins[dev] = out, margin
    if toks["cuda"] != toks["cpu"]:
        fail(f"granite kv_cache_quant decode: card {toks['cuda']} vs CPU "
             f"{toks['cpu']}")
    p = tree_map(lambda t: t.to("cuda"), params)
    with torch.no_grad():
        h, _, pc = M.forward_full(p, cfg, torch.tensor([prompt],
                                                       device="cuda"),
                                  return_caches=True)
        ref = [int(M.logits_for(p, cfg, h[0, -1]).argmax())]
        dc = M.prefill_to_decode_caches(cfg, pc, len(prompt), 256)
        for i in range(7):
            lg, dc = M.decode_step(p, cfg, torch.tensor([[ref[-1]]],
                                                        device="cuda"),
                                   dc, len(prompt) + i)
            ref.append(int(lg[0, 0].argmax()))
    w = init_adapter_weights(gen, cfg, 8, device="cpu")
    eng = Engine(cfg, params, device="cuda", adapters=[(AdapterSpec(
        "uq", rank=8, invocation_tokens=INV), w)])
    rid = eng.submit(prompt, 8)
    eng.run_until_idle()
    got = eng.request(rid).output_tokens
    if got != ref:
        fail(f"granite engine on the card {got} vs forward_full -> "
             f"decode_step {ref}")
    print(f"  granite-3.2-8b-reduced: kv_cache_quant 16 decode tokens card "
          f"== CPU (smallest top-1/top-2 margin card {margins['cuda']:.3e}, "
          f"CPU {margins['cpu']:.3e}); the card's engine emits forward_full "
          f"-> decode_step's 8 greedy tokens", flush=True)
    return {"quant_tokens_equal": True, "quant_min_top2_margin": margins,
            "engine_tokens_equal": True}


def full_model_path(torch):
    """Phase 8.  Every kernel count is set to 0 just before each main-path
    run and read just after (in the functions above)."""
    from repro_torch.kernels.bench import Timer
    timer = Timer("cuda")
    out = {}
    t0 = time.perf_counter()
    out["b6"] = check_full_b6(torch, timer)
    out["granite"] = full_granite(torch)
    out["mamba2"] = full_mamba2(torch, timer)
    del timer
    torch.cuda.empty_cache()
    out["training"] = full_training(torch)
    t1 = time.perf_counter()
    out["parity"] = {arch: reduced_full_parity(torch, arch)
                     for arch in PARITY_FULL}
    out["parity"]["granite-3.2-8b/quant_engine"] = \
        reduced_quant_and_engine(torch)
    out["seconds"] = {"full_width": t1 - t0,
                      "parity": time.perf_counter() - t1}
    print(f"  phase 8: full width {out['seconds']['full_width']:.1f} s, "
          f"parity {out['seconds']['parity']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 9: the sharded mixed step (EngineConfig.mesh) on ranks sharing the
# card (repro_torch.distributed.spawn: gloo, one process per rank)
# ---------------------------------------------------------------------------
TP_ARCHS = ("granite-3.2-8b", "mamba2-2.7b", ENCDEC_ARCH)
# 9(c)'s depth cut of mamba2-2.7b (64 layers), for the phase's time budget
MAMBA_TP_LAYERS = 16
TP_PREEMPT = dict(num_blocks=8, max_running=2)
# 9(a)'s float32 check at granite's full widths, cut to this many layers
TP_WIDE_LAYERS = 2
# the reduced float32 cases: (name, arch, workload, engine keywords)
TP_CASES_2 = [(f"{a}@1x2", a, "workload", {}) for a in TP_ARCHS]
TP_CASES_4 = ([(f"{a}@2x2", a, "workload", {}) for a in TP_ARCHS]
              + [("granite-3.2-8b@1x4", "granite-3.2-8b", "workload",
                  dict(mesh=(1, 4))),
                 ("preemption@2x2", "granite-3.2-8b", "preemption",
                  TP_PREEMPT)])


def tp_zoo(torch):
    """The reduced float32 models of 9(a) on the CPU: weights from a seed
    and three rank-8 adapters (B amplified 30×, the reference test's), the
    odd ones aLoRA."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.alora import AdapterSpec, init_adapter_weights
    from repro_torch.models.model import init_params
    zoo = {}
    for arch in TP_ARCHS:
        cfg = get_reduced(arch)
        params = init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
        ads = []
        for i in range(3):
            w = init_adapter_weights(torch.Generator().manual_seed(100 + i),
                                     cfg, 8, device="cpu")
            ads.append((AdapterSpec(f"ad{i}", 8, INV if i % 2 else None),
                        {seg: {k: v * 30.0 if k.startswith("b") else v
                               for k, v in leaves.items()}
                         for seg, leaves in w.items()}))
        zoo[arch] = (cfg, params, ads)
    return zoo


def tp_unsharded(torch, zoo):
    """9(a)'s oracle: every reduced case on one unsharded card engine."""
    from repro_torch.benchmarks import sharded_step as S
    from repro_torch.serving import Engine, EngineConfig
    out = {}
    for name, arch, workload, kw in TP_CASES_2 + TP_CASES_4:
        kw = {k: v for k, v in kw.items() if k != "mesh"}
        cfg, params, ads = zoo[arch]
        eng = Engine(cfg, params, adapters=ads, device="cuda",
                     engine_cfg=EngineConfig(**{**S.ENGINE, **kw}))
        run = S.run_preemption if workload == "preemption" \
            else S.run_workload
        out[name] = run(eng)
    return out


def tp_profile(torch, eng, cfg, profiled: bool, n_steps: int = 8):
    """A decode window on a sharded engine (4 requests, 256-token
    contexts): every rank steps alike, ``profiled`` (rank 0) under
    torch.profiler.  Returns its wall ms a step and its device busy ms a
    step, split into kernels and each way of copy (gloo stages every
    collective's payload through host memory: a DtoH and an HtoD copy
    each; the runner's own uploads are ~17 small HtoD a step)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(1)
    for _ in range(4):
        eng.submit(list(rng.randint(10, cfg.vocab_size, 256)),
                   2 * n_steps + 8)
    for _ in range(64):
        eng.step()
        if eng.running and not eng.waiting and not eng.last_step_tokens[1]:
            break
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    out = {"step_ms": step_ms}
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_steps):
                eng.step()
            torch.cuda.synchronize()
    else:
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
    eng.run_until_idle()
    if not profiled:
        return out

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0) or 0
    ev = [e for e in prof.key_averages()
          if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    per = lambda es: sum(dev_us(e) for e in es) / 1e3 / n_steps  # noqa: E731
    n = lambda es: sum(e.count for e in es) / n_steps  # noqa: E731
    dtoh = [e for e in ev if "DtoH" in e.key]
    htod = [e for e in ev if "HtoD" in e.key]
    out.update(device_busy_ms=per(ev), dtoh_ms=per(dtoh), dtoh_per_step=n(dtoh),
               htod_ms=per(htod), htod_per_step=n(htod),
               kernel_ms=per([e for e in ev if "Memcpy" not in e.key
                              and "Memset" not in e.key]))
    busy = out["device_busy_ms"] or float("nan")
    out["copy_share_of_busy"] = (out["dtoh_ms"] + out["htod_ms"]) / busy
    return out


def tp_slicer(cfg, rank):
    """``init_params``'s ``shard``: each layer cut to the rank's slice as
    it is drawn (None without a rank: the whole model)."""
    if rank is None:
        return None
    from repro_torch.distributed.sharding import (axis_sizes, rank_layout,
                                                  shard_tree)
    lay = rank_layout(cfg, axis_sizes(rank.mesh)["model"],
                      rank.coords["model"])
    return lambda path, tree: shard_tree(tree, lay)


def tp_wide_f32(torch, rank=None):
    """granite-3.2-8b's full widths (49,664-row padded vocab, 32/8 heads
    of 128, d_ff 12,800) at ``TP_WIDE_LAYERS`` layers in float32, three
    amplified rank-8 adapters drawn on the card from a seed, through the
    reference test's workload on an engine over ``mesh`` (None: one
    unsharded engine).  Float32, so the sharded tokens must equal the
    unsharded ones exactly at the production layout."""
    device = "cuda" if rank is None else rank.device
    from repro_torch.benchmarks import sharded_step as S
    from repro_torch.configs import get_config
    from repro_torch.core.alora import AdapterSpec, init_adapter_weights
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.models.model import init_params
    cfg = get_config("granite-3.2-8b").replace(num_layers=TP_WIDE_LAYERS,
                                               dtype="float32")
    gen = torch.Generator(device=device).manual_seed(3)
    params = init_params(gen, cfg, device=device, shard=tp_slicer(cfg, rank))
    ads = [(AdapterSpec(f"ad{i}", 8, INV if i % 2 else None),
            {seg: {k: v * 30.0 if k.startswith("b") else v
                   for k, v in leaves.items()}
             for seg, leaves in init_adapter_weights(
                 gen, cfg, 8, device=device).items()})
           for i in range(3)]
    eng = Engine(cfg, params, adapters=ads, device=device,
                 engine_cfg=EngineConfig(**S.ENGINE, mesh=rank and rank.mesh))
    del params, ads
    out = S.run_workload(eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_full(torch, rank, arch, num_layers=0, profile=False):
    """Serve ``arch`` at full width (``num_layers`` of its layers where
    given) on this rank of the mesh: weights drawn as phase 3 draws them
    (same seed and order), each layer cut to the rank's slice as it is
    drawn, one rank-32 aLoRA adapter, phase 3's ``PIPE``, the serving
    kernels' counts set to 0 just before and read just after."""
    from repro_torch.configs import SSM, get_config
    from repro_torch.core.alora import AdapterSpec, init_adapter_weights
    from repro_torch.distributed.sharding import tree_bytes
    from repro_torch.models.model import init_params
    from repro_torch.serving import Engine, EngineConfig
    cfg = get_config(arch)
    if num_layers:
        cfg = cfg.replace(num_layers=num_layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(gen, cfg, device="cuda", shard=tp_slicer(cfg, rank))
    adapter = init_adapter_weights(gen, cfg, 32, device="cuda")
    eng = Engine(cfg, params, device="cuda",
                 adapters=[(AdapterSpec("eval", 32, INV), adapter)],
                 engine_cfg=EngineConfig(mesh=rank.mesh))
    del params, adapter
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    weights_bytes = tree_bytes(eng.runner.params)
    weights_gb = weights_bytes / 1e9
    reset_counts()
    res, step_ms = run_pipeline(torch, eng, **PIPE)
    counts = dict(zip(SERVING, read_counts()))
    steps = eng.runner.call_counts["mixed_step"]
    Ls = cfg.pattern().count(SSM)
    La = cfg.num_layers - Ls
    want = dict(zip(SERVING, (La * steps, Ls * steps, La * steps,
                              Ls * steps)))
    if counts != want:
        fail(f"rank {rank.rank} {arch}: launches {counts} != {want} over "
             f"{steps} mixed steps")
    ids = res.base_ids + res.eval_ids
    out = {"arch": arch, "num_layers": cfg.num_layers, "steps": steps,
           "launches": counts, "weights_gb": weights_gb,
           "weights_bytes": weights_bytes, "setup_s": setup_s,
           "step_ms_mean": statistics.mean(step_ms),
           "step_ms_median": statistics.median(step_ms),
           "outputs": [list(map(int, eng.request(i).output_tokens))
                       for i in ids],
           "eval_cache_hits": [eng.request(i).n_cache_hit_tokens
                               for i in res.eval_ids],
           "eval_state_reused": [eng.request(i).state_reused
                                 for i in res.eval_ids],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    from repro_torch.benchmarks.sharded_step import leaks
    if leaks(eng):
        fail(f"rank {rank.rank} {arch}: {leaks(eng)} leaked after the drain")
    if profile:
        out["decode"] = tp_profile(torch, eng, cfg, rank.rank == 0)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_collectives(torch, rank, n: int = 20):
    """Wall ms of one collective of the sharded step on this rank's model
    group (gloo, the card's tensors staged through host memory): the
    row-parallel all_reduce of a decode step's (4, 4096) and a prefill
    chunk's (128, 4096) bf16 rows, and the logits' all_gather of (4,
    24832) bf16 (granite's padded vocab over two ranks)."""
    import torch.distributed as dist
    group = rank.mesh.get_group("model")
    out = {}
    for name, shape in (("all_reduce_4x4096", (4, 4096)),
                        ("all_reduce_128x4096", (128, 4096)),
                        ("all_gather_4x24832", (4, 24832))):
        x = torch.randn(shape, device="cuda", dtype=torch.bfloat16)
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]

        def once():
            if name.startswith("all_reduce"):
                dist.all_reduce(x, group=group)
            else:
                dist.all_gather(parts, x, group=group)
        for _ in range(3):
            once()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            once()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3 / n
    return out


def tp_rank(rank, zoo, cases, full):
    """One rank of phase 9: the reduced cases, then (``full``) 9(b) and
    9(c) at full width."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.benchmarks import sharded_step as S
    out = {"reduced": S.serve_cases(rank, zoo, cases)}
    if full:
        out["collective_ms"] = tp_collectives(torch, rank)
        out["wide_f32"] = tp_wide_f32(torch, rank)
        out["granite"] = tp_full(torch, rank, "granite-3.2-8b", profile=True)
        out["mamba2"] = tp_full(torch, rank, "mamba2-2.7b",
                                num_layers=MAMBA_TP_LAYERS)
    return out


def agreement_of(a, b) -> str:
    same = sum(x == y for p, q in zip(a, b) for x, y in zip(p, q))
    return f"{same}/{sum(len(p) for p in a)}"


def sharded_step(torch, phase3):
    """Phase 9.  (a) The reduced float32 granite, mamba2 and whisper at
    (data=1, model=2) and (2, 2), granite at (1, 4) (its two K/V heads
    replicated), a preemption case at (2, 2) and granite's full widths ×
    ``TP_WIDE_LAYERS`` layers in float32 at (1, 2), each equal to the
    unsharded card engine (tokens, reused tokens, evictions,
    preemptions, steps) with one mixed step per work step and per-layer
    launches on every rank.  (b) granite-3.2-8b at full width and depth in
    bf16 at model=2, phase 3's pipeline: 40 B1 and 40 fused B2 a mixed
    step on each rank, the evals' reuse equal to phase 3's, weights per
    rank, wall ms a mixed step, token agreement with phase 3 (printed),
    rank 0's device busy ms a decode step and its copies' share.  (c)
    mamba2-2.7b at full width, ``MAMBA_TP_LAYERS`` layers, model=2: B3
    and B2's one-pair entry once per SSM layer of each rank's mixed step,
    every eval restoring a state snapshot."""
    import threading

    from repro_torch.distributed.spawn import launch
    zoo = tp_zoo(torch)
    four = {}

    def run_four():
        try:
            four["res"] = launch(tp_rank, zoo, TP_CASES_4, False, data=2,
                                 model=2, device="cuda", timeout=400)
        except Exception as e:      # re-raised below
            four["res"] = e
    t0 = time.perf_counter()
    th = threading.Thread(target=run_four)
    th.start()
    want = tp_unsharded(torch, zoo)
    th.join()
    if isinstance(four["res"], Exception):
        raise four["res"]
    t4 = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wide = tp_wide_f32(torch)
    gc.collect()
    torch.cuda.empty_cache()
    two = launch(tp_rank, zoo, TP_CASES_2, True, data=1, model=2,
                 device="cuda", timeout=600)
    t2 = time.perf_counter() - t0
    for i, r in enumerate(two):
        if r["wide_f32"] != wide:
            fail(f"9(a) granite widths x {TP_WIDE_LAYERS} layers, float32, "
                 f"model=2, rank {i}: {r['wide_f32']} != the unsharded "
                 f"card's {wide}")
    print(f"  9(a) granite-3.2-8b widths x {TP_WIDE_LAYERS} layers, float32, "
          f"model=2: tokens, hits {wide[1]['hits']}, steps "
          f"{wide[1]['steps']}, evictions {wide[1]['evictions']} equal the "
          "unsharded card's on both ranks", flush=True)
    print(f"  world of 4 ranks {t4:.1f} s (with the unsharded runs), world "
          f"of 2 ranks {t2:.1f} s", flush=True)
    summary = {"world4_s": t4, "world2_s": t2, "reduced": {},
               "wide_f32": wide[1]}
    for world, cases in ((four["res"], TP_CASES_4), (two, TP_CASES_2)):
        for name, arch, workload, _ in cases:
            res = [r["reduced"][name] for r in world]
            toks, st = want[name]
            for i, r in enumerate(res):
                if r["tokens"] != toks or any(r["stats"][k] != st[k]
                                              for k in st):
                    fail(f"9(a) {name} rank {i}: {r['tokens']} {r['stats']} "
                         f"!= the unsharded card's {toks} {st}")
                if r["leaks"]:
                    fail(f"9(a) {name} rank {i} leaked {r['leaks']}")
                if workload == "workload" and \
                        r["stats"]["mixed_calls"] != r["stats"]["steps"]:
                    fail(f"9(a) {name}: {r['stats']}")
                cfg = zoo[arch][0]
                calls = r["call_counts"]["mixed_step"]
                Ls = cfg.pattern().count("ssm")
                La = cfg.num_layers - Ls
                if r["launches"] != dict(zip(SERVING, (
                        La * calls, Ls * calls, La * calls, Ls * calls))):
                    fail(f"9(a) {name} rank {i}: launches {r['launches']} "
                         f"over {calls} mixed steps")
            summary["reduced"][name] = {
                "steps": st.get("steps"), "hits": st["hits"],
                "preemptions": st["preemptions"],
                "k_pool_per_rank": res[0]["k_pool"],
                "live_ssm_per_rank": res[0]["live_ssm"],
                "launches_rank0": res[0]["launches"]}
            print(f"  9(a) {name}: tokens, hits {st['hits']}, steps "
                  f"{st.get('steps')}, preemptions {st['preemptions']} equal "
                  f"the unsharded card's on every rank; launches rank 0 "
                  f"{res[0]['launches']}", flush=True)
    for key, p3 in (("granite", phase3["granite-3.2-8b"]),
                    ("mamba2", phase3["mamba2-2.7b"])):
        ranks = [r[key] for r in two]
        for r in ranks[1:]:
            if r["outputs"] != ranks[0]["outputs"]:
                fail(f"9 {key}: the ranks sampled different tokens")
        r0 = ranks[0]
        if r0["eval_cache_hits"] != p3["eval_cache_hits"]:
            fail(f"9 {key}: eval reuse {r0['eval_cache_hits']} != phase 3's "
                 f"{p3['eval_cache_hits']}")
        if key == "mamba2" and not all(r0["eval_state_reused"]):
            fail(f"9 mamba2: an eval restored no state snapshot: "
                 f"{r0['eval_state_reused']}")
        agree = agreement_of(r0["outputs"], p3["outputs"]) \
            if r0["num_layers"] == p3["num_layers"] else None
        entry = {k: r0[k] for k in r0 if k != "outputs"}
        entry.update(agreement_with_phase3=agree,
                     weights_gb_per_rank=[r["weights_gb"] for r in ranks],
                     weights_bytes_per_rank=[r["weights_bytes"]
                                             for r in ranks],
                     launches_per_rank=[r["launches"] for r in ranks],
                     unsharded_weights_gb=p3["weights_gb"],
                     unsharded_step_ms_mean=p3["step_ms_mean"])
        summary[key] = entry
        print(f"  9 {key} ({r0['num_layers']} layers, model=2): weights "
              f"{entry['weights_gb_per_rank']} GB a rank (unsharded "
              f"{p3['weights_gb']:.2f}), {r0['steps']} mixed steps, "
              f"{r0['step_ms_mean']:.2f} ms mean / {r0['step_ms_median']:.2f} "
              f"median a step (unsharded {p3['step_ms_mean']:.2f}), launches "
              f"{r0['launches']} on each rank, eval reuse "
              f"{r0['eval_cache_hits']}, state_reused "
              f"{r0['eval_state_reused']}, tokens agreeing with phase 3 "
              f"{agree}, set-up {r0['setup_s']:.1f} s, peak "
              f"{r0['peak_memory_gb']:.2f} GB", flush=True)
    summary["collective_ms"] = two[0]["collective_ms"]
    print("  collectives on rank 0, wall ms each: " + ", ".join(
        f"{k} {v:.3f}" for k, v in summary["collective_ms"].items()),
        flush=True)
    dec = summary["granite"].get("decode", {})
    print(f"  9 granite decode window, rank 0: {dec.get('step_ms', 0):.2f} ms "
          f"a step; device busy {dec.get('device_busy_ms')} ms (kernels "
          f"{dec.get('kernel_ms')}, DtoH {dec.get('dtoh_ms')} ms in "
          f"{dec.get('dtoh_per_step')}, HtoD {dec.get('htod_ms')} ms in "
          f"{dec.get('htod_per_step')} a step; copies "
          f"{dec.get('copy_share_of_busy')} of busy)", flush=True)
    return summary


# ---------------------------------------------------------------------------
# phase 10: the sharded full-sequence model, decode step and training
# (models.model under Runtime.mesh) on ranks sharing the card
# ---------------------------------------------------------------------------
FM_TOL = 1e-5
FM_B, FM_S = 2, 16
FM_ARCHS = {"granite-3.2-8b": 16, "mamba2-2.7b": 4,   # arch: decode steps
            "whisper-large-v3": 4}
FM_MOE, FM_CP = "granite-moe-1b-a400m", "stablelm-12b"
FM_CAPS = (32.0, 0.05)
FM_EP = {"moe_impl": "expert_parallel", "capacity_factor": 32.0}
# 10(b): mamba2-2.7b's depth cut (64 layers) and the train step's shape
FM_MAMBA_LAYERS = 16
FM_TRAIN = dict(layers=4, B=4, S=1024)


def fm_zoo(torch):
    """10(a)'s reduced float32 models on the CPU, weights from a seed:
    (cfg, params, stacked adapters | None, inputs) by arch, granite's
    and mamba2's one rank-8 adapter (B amplified 30×) on the second half
    of every row; the MoE layer's input, the context-parallel and train
    inputs."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.alora import init_adapter_weights, stack_adapters
    from repro_torch.models.model import init_params
    zoo = {}
    for arch in (*FM_ARCHS, FM_MOE, FM_CP):
        cfg = get_reduced(arch)
        params = init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
        rng = np.random.RandomState(1)
        inputs = {"tokens": rng.randint(0, cfg.vocab_size, (FM_B, FM_S))}
        if cfg.frontend == "audio":
            inputs["extra_embeds"] = (rng.randn(
                FM_B, cfg.encoder_seq_len, cfg.d_model) * 0.05).astype(
                np.float32)
        ad = None
        if arch in ("granite-3.2-8b", "mamba2-2.7b"):
            w = init_adapter_weights(torch.Generator().manual_seed(5), cfg,
                                     8, device="cpu")
            ad = stack_adapters(cfg, [{s: {k: v * 30.0 if k[0] == "b" else v
                                           for k, v in l.items()}
                                       for s, l in w.items()}], 8)
            inputs["adapter_idx"] = np.where(
                np.arange(FM_S) >= FM_S // 2, 1, 0)[None].repeat(
                FM_B, 0).astype(np.int32)
        zoo[arch] = (cfg, params, ad, inputs)
    rng = np.random.RandomState(2)
    cfg = zoo[FM_MOE][0]
    zoo["moe_x"] = rng.randn(4, 8, cfg.d_model).astype(np.float32)
    cfg = zoo[FM_CP][0]
    zoo["cp"] = (rng.randint(0, cfg.vocab_size, (4, 32)),
                 rng.randn(4, 32, cfg.d_model).astype(np.float32))
    zoo["train"] = {}
    for arch in ("granite-3.2-8b", FM_MOE):
        cfg = zoo[arch][0]
        zoo["train"][arch] = {
            "tokens": rng.randint(0, cfg.vocab_size, (4, FM_S)),
            "labels": rng.randint(0, cfg.vocab_size, (4, FM_S)),
            "mask": (rng.rand(4, FM_S) > 0.2).astype(np.float32)}
    return zoo


def fm_cases(zoo, world: str):
    """10(a)'s cases of a world: ``(name, kind, args, keywords)`` of
    ``sharded_model.run_cases``, and each case's unsharded twin."""
    cases = []
    tags = [("", {})] if world == "2" else [("", {}), ("@1x4", {"mesh": (1, 4)})]
    for tag, kw in tags:
        for arch, decode in FM_ARCHS.items():
            if tag and arch != "granite-3.2-8b":
                continue
            cfg, params, ad, inputs = zoo[arch]
            cases.append((arch + tag, "model", (cfg, params, inputs),
                          dict(adapters=ad, decode=decode, **kw)))
    cfg, params, _, _ = zoo[FM_MOE]
    for cap in FM_CAPS:
        cases.append((f"moe{cap}", "moe", (cfg, params["layers"][0]["moe"],
                                          zoo["moe_x"]),
                      dict(capacity_factor=cap)))
    cfg, params, _, _ = zoo[FM_CP]
    cases.append(("cp", "cp", (cfg, params) + zoo["cp"], {}))
    # granite-moe: expert-parallel at (1, 2); masked dense at (2, 2), where
    # its aux takes the global batch's statistics like the unsharded one
    # (expert-parallel aux is the data shards' mean, the reference's pmean)
    trains = [("granite-3.2-8b", {}), (FM_MOE, FM_EP if world == "2" else {})]
    for arch, kw in trains:
        cfg, params, _, _ = zoo[arch]
        cases.append((f"train/{arch}" + ("/ep" if kw else ""), "train",
                      (cfg, params, zoo["train"][arch]), dict(rt_kw=kw)))
    if world == "4":
        cfg, params, _, _ = zoo["granite-3.2-8b"]
        cases.append(("train/granite-3.2-8b@1x4", "train",
                      (cfg, params, zoo["train"]["granite-3.2-8b"]),
                      dict(rt_kw={}, mesh=(1, 4))))
    return cases


def fm_unsharded(torch, zoo):
    """10(a)'s oracle: every case unsharded on the card (the MoE layer on
    each data shard's rows)."""
    from repro_torch.benchmarks import sharded_model as SM
    out = {}
    for name, kind, args, kw in fm_cases(zoo, "2") + fm_cases(zoo, "4"):
        kw = {k: v for k, v in kw.items() if k != "mesh"}
        if kind == "moe":
            x = args[2]
            for rows in ((0, 4), (0, 2), (2, 4)):
                out[(name, rows)] = SM.to_numpy(SM.moe_case(
                    args[0], args[1], x[rows[0]:rows[1]], device="cuda",
                    **kw))
            continue
        if name not in out:
            out[name] = SM.to_numpy(SM.CASES[kind](*args, device="cuda",
                                                   **kw))
    torch.cuda.synchronize()
    return out


def fm_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        fail(f"shape {got.shape} != {want.shape}")
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def fm_check(zoo, world, res, want) -> dict:
    """Hold every rank's 10(a) results to the unsharded card's; returns
    the worst error of each case and the launches of rank 0."""
    from repro_torch.common import tree_map, tree_paths
    from repro_torch.distributed.sharding import shard_params
    from repro_torch.training.optimizer import AdamWState
    from repro_torch.training.train_loop import (TrainState,
                                                 gather_train_states)
    mesh_of = {"2": (1, 2), "4": (2, 2)}
    out = {}
    for name, kind, args, kw in fm_cases(zoo, world):
        data, model = kw.get("mesh", mesh_of[world])
        label = f"10(a) {name} at ({data}, {model})"
        ranks = [r["reduced"][name] for r in res]
        worst = 0.0
        if kind == "model":
            w = want[name]
            cfg, ad = args[0], kw.get("adapters")
            Ls = cfg.pattern().count("ssm")
            n = {"alora_qkv": 0 if ad is None else
                 3 * (cfg.num_layers - Ls) * (1 + kw["decode"]),
                 # the SSM input projection's delta, a forward and a step
                 "ragged_grouped_lora": 0 if ad is None else
                 Ls * (1 + kw["decode"]),
                 "ssd_chunk_scan": Ls}       # forward_full's dense scan
            for i, r in enumerate(ranks):
                got = {k: r["launches"].get(k, 0) for k in n}
                if got != n:
                    fail(f"{label}: rank {i} launched {got}, not {n}")
            for r in ranks:
                worst = max(worst, fm_rel(r["hidden"], w["hidden"]),
                            fm_rel(r["logits"], w["logits"]))
                if not np.array_equal(r["tokens"], w["tokens"]):
                    fail(f"{label}: greedy tokens {r['tokens'].tolist()} != "
                         f"the unsharded card's {w['tokens'].tolist()}")
        elif kind == "moe":
            auxes = []
            for r in ranks:
                w = want[(name, tuple(r["rows"]))]
                worst = max(worst, fm_rel(r["y"], w["y"]))
                drop = np.abs(w["y"]).sum(-1) < 1e-12
                if not np.array_equal(np.abs(r["y"]).sum(-1) < 1e-12, drop):
                    fail(f"{label}: dropped rows differ")
                auxes.append(w["aux"])
            aux = float(np.mean(auxes[::model]))
            if any(abs(r["aux"] - aux) > 1e-6 for r in ranks):
                fail(f"{label}: aux {[r['aux'] for r in ranks]} != {aux}")
        elif kind == "cp":
            w = want[name]
            for r in ranks:
                worst = max(worst, fm_rel(r["hidden"], w["hidden"]))
                for path, g in tree_paths(r["grads"]):
                    gw = w["grads"]
                    for k in path:
                        gw = gw[k]
                    if np.abs(gw).max() > 0:
                        worst = max(worst, fm_rel(g, gw))
        else:
            import torch
            w = want[name]
            for k in ("loss", "ce", "aux", "grad_norm"):
                for r in ranks:
                    e = abs(r["stats"][k] - w["stats"][k]) / max(
                        abs(w["stats"][k]), 1e-6)
                    worst = max(worst, e)
            tt = lambda t: tree_map(torch.from_numpy, t)  # noqa: E731
            states = [TrainState(tt(r["params"]), AdamWState(
                torch.tensor(r["step"]), tt(r["mu"]), tt(r["nu"])))
                for r in ranks]
            cfg = args[0]
            got = gather_train_states(states, cfg, {"data": data,
                                                    "model": model})
            scale = max(float(np.abs(v).max()) for _, v in
                        tree_paths(w["params"]))
            for path, a in tree_paths(got.params):
                ref = w["params"]
                for k in path:
                    ref = ref[k]
                worst = max(worst, float(np.abs(a.numpy() - ref).max())
                            / scale)
            for key in ("mu", "nu"):
                for path, a in tree_paths(getattr(got.opt, key)):
                    ref = w[key]
                    for k in path:
                        ref = ref[k]
                    worst = max(worst, fm_rel(a.numpy(), ref))
            for i, st in enumerate(states):
                mine = shard_params(got.params, cfg, {"data": data,
                                                      "model": model},
                                    {"data": i // model, "model": i % model})
                for path, a in tree_paths(st.params):
                    ref = mine
                    for k in path:
                        ref = ref[k]
                    if not torch.equal(a, ref):
                        fail(f"{label}: rank {i}'s copy of {path} differs")
        if worst > FM_TOL:
            fail(f"{label}: {worst:.3e} of max|unsharded| > {FM_TOL}")
        out[name] = {"worst_rel_err": worst,
                     "launches_rank0": {k: v for k, v in
                                        ranks[0]["launches"].items() if v},
                     "collectives_rank0": ranks[0]["collectives"]}
        print(f"  {label}: within {worst:.2e} of the unsharded card's "
              f"(tol {FM_TOL}); launches rank 0 {out[name]['launches_rank0']}",
              flush=True)
    return out


def fm_vs_plain(torch, calls, kernel, plain, shape_of):
    """Each call of a kernel's wrapper recorded on this rank's slice
    (``first_call``) run again through the kernel and through its plain
    version on the same tensors: its shape, max |err| and that over max
    |plain| (the worst output)."""
    out = []
    for args in calls:
        got, want = kernel(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max((rel_err(g, w) for g, w in zip(got, want)),
                  key=lambda e: e[1])
        out.append({"shape": shape_of(args), "max_abs_err": err[0],
                    "rel_err": err[1]})
    torch.cuda.synchronize()
    return out


def fm_b6_shape(args):
    x, w, a = args[:3]
    return (f"T={x.shape[0]} {w.shape[0]}->{w.shape[1]} n={a.shape[0]} "
            f"r={a.shape[-1]}")


def fm_full_granite(torch, rank):
    """10(b) granite-3.2-8b at full width and depth in bf16 on this rank
    of a model=2 mesh: the weights drawn as phase 8 draws them and cut
    to the rank's slice layer by layer, four rank-32 adapters (B on the
    rank's columns), ``forward_full`` on ``GRANITE_FULL``'s 2 × 1,024
    tokens (row 1 on adapter 1 from token 512), then 4 greedy
    ``decode_step``\\ s: B6's launches and the wall ms of each, the peak
    GB; layer 0's Q, K and V calls of the warm-up forward and step on
    the rank's columns through B6 and ``alora_qkv_ref``."""
    from repro_torch.configs import get_config
    from repro_torch.core.alora import init_adapter_weights, stack_adapters
    from repro_torch.distributed.sharding import (shard_adapter_layers,
                                                  tree_bytes)
    from repro_torch.kernels.alora_qkv import alora_qkv, alora_qkv_ref
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    g = GRANITE_FULL
    cfg = get_config("granite-3.2-8b")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = M.init_params(gen, cfg, device="cuda",
                           shard=tp_slicer(cfg, rank))
    ads = stack_adapters(cfg, [init_adapter_weights(gen, cfg, g["rank"],
                                                    device="cuda")
                               for _ in range(g["adapters"])], g["rank"])
    ads = shard_adapter_layers(ads, cfg, rank.mesh, rank.coords)
    rt = M.Runtime(mesh=rank.mesh, batch_axes=("data",))
    B, S, n = g["B"], g["S"], 4
    toks = torch.randint(10, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda")
    aidx = torch.zeros((B, S), dtype=torch.int32, device="cuda")
    aidx[1, g["act"]:] = 1
    on = torch.ones((B, 1), dtype=torch.int32, device="cuda")
    out = {"weights_bytes": tree_bytes(params),
           "adapter_bytes": tree_bytes(ads), "layers": cfg.num_layers}
    with torch.no_grad():
        with first_call(L, "alora_qkv", 3) as fwd_calls:   # layer 0's Q/K/V
            M.forward_full(params, cfg, toks, rt, adapters=ads,
                           adapter_idx=aidx)
        alora_qkv.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h, _, caches = M.forward_full(params, cfg, toks, rt, adapters=ads,
                                      adapter_idx=aidx, return_caches=True)
        torch.cuda.synchronize()
        out["forward_ms"] = (time.perf_counter() - t0) * 1e3
        out["forward_launches_B6"] = alora_qkv.launches
        tok = M.logits_for(params, cfg, h[:, -1:], rt).argmax(-1)
        caches = M.prefill_to_decode_caches(cfg, caches, S, S + n + 1, rt)
        with first_call(L, "alora_qkv", 3) as step_calls:
            M.decode_step(params, cfg, tok, caches, S, rt, adapters=ads,
                          adapter_idx=on)
        alora_qkv.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks_out = []
        for i in range(n):
            lg, caches = M.decode_step(params, cfg, tok, caches, S + 1 + i,
                                       rt, adapters=ads, adapter_idx=on)
            tok = lg.argmax(-1)
            toks_out.append(tok[:, 0].tolist())
        torch.cuda.synchronize()
        out["decode_ms"] = (time.perf_counter() - t0) * 1e3 / n
        out["decode_launches_B6_per_step"] = alora_qkv.launches / n
        out["finite"] = bool(torch.isfinite(h).all()) and \
            bool(torch.isfinite(lg).all())
    out["tokens"] = toks_out
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["b6_vs_plain"] = fm_vs_plain(torch, fwd_calls + step_calls,
                                     alora_qkv, alora_qkv_ref, fm_b6_shape)
    del params, ads, caches, h, fwd_calls, step_calls
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fm_full_mamba2(torch, rank):
    """10(b) mamba2-2.7b at full width, ``FM_MAMBA_LAYERS`` layers, bf16 on
    this rank of a model=2 mesh: a no-grad ``forward_full`` on
    ``MAMBA_FULL``'s 2 × 2,048 tokens (B5 once a layer on the rank's 40
    heads), then an adapted one (one rank-32 adapter on row 1 from token
    1,024: B2's one-pair entry once a layer); layer 0's B5 and B2 calls
    of the warm-up forwards on the rank's heads and columns through the
    kernel and its plain version."""
    from repro_torch.configs import get_config
    from repro_torch.core.alora import init_adapter_weights, stack_adapters
    from repro_torch.distributed.sharding import shard_adapter_layers
    from repro_torch.kernels.ragged_lora import ragged_grouped_lora
    from repro_torch.kernels.ssd_chunk import ssd_chunk_scan
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import ssm
    m = MAMBA_FULL
    cfg = get_config("mamba2-2.7b").replace(num_layers=FM_MAMBA_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = M.init_params(gen, cfg, device="cuda",
                           shard=tp_slicer(cfg, rank))
    ads = shard_adapter_layers(stack_adapters(cfg, [init_adapter_weights(
        gen, cfg, 32, device="cuda")], 32), cfg, rank.mesh, rank.coords)
    rt = M.Runtime(mesh=rank.mesh, batch_axes=("data",))
    B, S = m["B"], m["S"]
    toks = torch.randint(10, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda")
    aidx = torch.zeros((B, S), dtype=torch.int32, device="cuda")
    aidx[1, S // 2:] = 1
    out = {"layers": cfg.num_layers}
    Q = min(cfg.ssm.chunk_size, S)
    with torch.no_grad():
        with first_call(ssm, "ssd_chunk_scan") as b5_calls:
            M.forward_full(params, cfg, toks, rt)
        ssd_chunk_scan.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h, _, _ = M.forward_full(params, cfg, toks, rt)
        torch.cuda.synchronize()
        out["forward_ms"] = (time.perf_counter() - t0) * 1e3
        out["forward_launches_B5"] = ssd_chunk_scan.launches
        with first_call(L, "ragged_grouped_lora") as b2_calls:
            M.forward_full(params, cfg, toks, rt, adapters=ads,
                           adapter_idx=aidx)
        ragged_grouped_lora.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ha, _, _ = M.forward_full(params, cfg, toks, rt, adapters=ads,
                                  adapter_idx=aidx)
        torch.cuda.synchronize()
        out["adapted_forward_ms"] = (time.perf_counter() - t0) * 1e3
        out["adapted_launches_B2"] = ragged_grouped_lora.launches
        out["finite"] = bool(torch.isfinite(h).all()) and \
            bool(torch.isfinite(ha).all())
        # the adapter moves only row 1's adapted positions
        out["row0_unchanged"] = bool(torch.equal(h[0], ha[0]))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["b5_vs_plain"] = fm_vs_plain(
        torch, b5_calls, ssd_chunk_scan,
        lambda *a: ssm.chunked_scan(*a, Q),
        lambda a: f"{tuple(a[0].shape)} N={a[1].shape[-1]}")
    out["b2_vs_plain"] = fm_vs_plain(
        torch, b2_calls, ragged_grouped_lora,
        lambda x, a, b, idx, act: lora_plain(x, [(a, b)], idx, act),
        lambda a: (f"T={a[0].shape[0]} d={a[0].shape[1]} out="
                   f"{a[2].shape[-1]} n={a[1].shape[0]} r={a[1].shape[-1]}"))
    del params, ads, h, ha, b5_calls, b2_calls
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fm_full_train(torch, rank):
    """10(b) one TP + ZeRO-1 train step (after a first one) at granite's
    widths × ``FM_TRAIN["layers"]`` layers in bf16 on this rank of the
    (2, 2) mesh, B 4 × S 1,024 from ``SyntheticDataset``, remat on (the
    train_4k runtime): the wall ms of the step, its loss and grad norm
    (equal on every rank), the peak GB."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.training import (AdamWConfig, DataConfig,
                                      SyntheticDataset, make_train_step)
    from repro_torch.training.train_loop import init_sharded_train_state
    t = FM_TRAIN
    cfg = get_config("granite-3.2-8b").replace(num_layers=t["layers"])
    gen = torch.Generator(device="cuda").manual_seed(3)
    params = M.init_params(gen, cfg, device="cuda",
                           shard=tp_slicer(cfg, rank))
    rt = M.Runtime(mesh=rank.mesh, batch_axes=("data",), remat=True)
    state = init_sharded_train_state(params, cfg, rt)
    batch = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=t["S"],
                                        global_batch=t["B"])).batch(0)
    step = make_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=20,
                                            total_steps=10), rt)
    state, stats = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, stats = step(state, batch)
    torch.cuda.synchronize()
    out = {"step_ms": (time.perf_counter() - t0) * 1e3,
           **{k: float(v) for k, v in stats.items()},
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del state, params, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def fm_rank(rank, cases, full):
    """One rank of phase 10: the reduced cases, then (``full``) 10(b)'s
    runs of this world."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.benchmarks import sharded_model as SM
    out = {"reduced": SM.run_cases(rank, cases)}
    if full == "model2":
        torch.cuda.reset_peak_memory_stats()
        out["granite"] = fm_full_granite(torch, rank)
        torch.cuda.reset_peak_memory_stats()
        out["mamba2"] = fm_full_mamba2(torch, rank)
    elif full == "train":
        torch.cuda.reset_peak_memory_stats()
        out["train"] = fm_full_train(torch, rank)
    return out


def fm_dryrun_records():
    """10(c)'s records: every assigned (arch × shape) on both production
    meshes (shape arithmetic, no card), and their seconds."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    recs = [dryrun.run_one(a, s, m, verbose=False)
            for a in dryrun.ASSIGNED_ARCHS for s in dryrun.INPUT_SHAPES
            for m in dryrun.MESHES]
    return recs, time.perf_counter() - t0


def fm_dryrun(tp_summary, measured, recs, seconds):
    """10(c): the dry run's records all sized, each rank's arguments
    against 80 GB, then granite-3.2-8b's per-rank param bytes at model=2
    against phase 9's measured bytes on each rank and 10(b)'s
    (``measured``)."""
    from repro_torch.launch import dryrun
    bad = [(r["arch"], r["shape"], r["mesh"], r.get("error"))
           for r in recs if not r["ok"]]
    if bad:
        fail(f"10(c) dry run failed: {bad}")
    worst = {}
    for r in recs:
        key = f"{r['shape']}/{r['mesh']}"
        gb = r["memory"]["argument_size_in_bytes"] / 1e9
        if gb >= worst.get(key, (0, ""))[0]:
            worst[key] = (gb, r["arch"])
    g = dryrun.run_one("granite-3.2-8b", "prefill_32k", "1x2", verbose=False,
                       mesh={"data": 1, "model": 2})
    want = tp_summary["granite"]["weights_bytes_per_rank"]
    got = g["memory"]["params_bytes"]
    if any(got != w for w in want + measured):
        fail(f"10(c) dry-run param bytes of granite-3.2-8b at model=2 {got} "
             f"!= phase 9's measured {want} or 10(b)'s {measured} a rank")
    print(f"  10(c) dry run: {len(recs)} records (both meshes), "
          f"{seconds:.1f} s; granite-3.2-8b at model=2: "
          f"{got} param bytes a rank = phase 9's measured {want} = 10(b)'s "
          f"{measured}", flush=True)
    for key, (gb, arch) in sorted(worst.items()):
        print(f"  10(c) {key}: largest arguments a rank {gb:.2f} GB "
              f"({arch}) of 80 GB (activations not estimated)", flush=True)
    fits = all(r["fits_without_activations"] for r in recs)
    return {"records": len(recs), "seconds": seconds,
            "all_fit_without_activations": fits,
            "largest_args_gb": {k: list(v) for k, v in worst.items()},
            "granite_model2_param_bytes": got,
            "phase9_param_bytes": want, "phase10b_param_bytes": measured,
            "records_16x16": {f"{r['arch']}/{r['shape']}": {
                "args_gb": r["memory"]["argument_size_in_bytes"] / 1e9,
                "out_gb": r["memory"]["output_size_in_bytes"] / 1e9,
                "dominant": r["roofline"]["dominant"],
                "compute_s": r["roofline"]["compute_s"],
                "memory_s": r["roofline"]["memory_s"],
                "collective_s": r["roofline"]["collective_s"]}
                for r in recs if r["mesh"] == "16x16"}}


def fm_plain_check(label, calls, tol, shapes) -> float:
    """Fail unless the recorded calls (``fm_vs_plain``) ran at ``shapes``
    and each is within ``tol`` of max |plain|; the worst error."""
    got = [c["shape"] for c in calls]
    if got != shapes:
        fail(f"{label}: calls at {got}, not {shapes}")
    worst = max(c["rel_err"] for c in calls)
    if worst > tol:
        fail(f"{label} vs its plain version: {worst} of max|plain| > {tol}")
    return worst


def sharded_model_path(torch, tp_summary):
    """Phase 10 (see the module docstring): the (2, 2) world (10(a) and
    the train step of 10(b)) runs in the background while the parent
    computes 10(a)'s unsharded card runs; then the (1, 2) world (10(a)
    and 10(b)'s granite and mamba2) while the parent sizes 10(c)'s dry
    run (host arithmetic, no card)."""
    import threading

    from repro_torch.distributed.spawn import launch
    torch.backends.cuda.matmul.allow_tf32 = False
    zoo = fm_zoo(torch)
    four = {}

    def run_four():
        try:
            four["res"] = launch(fm_rank, fm_cases(zoo, "4"), "train",
                                 data=2, model=2, device="cuda", timeout=400)
        except Exception as e:      # re-raised below
            four["res"] = e
    t0 = time.perf_counter()
    th = threading.Thread(target=run_four)
    th.start()
    want = fm_unsharded(torch, zoo)
    gc.collect()
    torch.cuda.empty_cache()
    th.join()
    if isinstance(four["res"], Exception):
        raise four["res"]
    t4 = time.perf_counter() - t0
    t0 = time.perf_counter()
    res2 = {}

    def run_two():
        try:
            res2["res"] = launch(fm_rank, fm_cases(zoo, "2"), "model2",
                                 data=1, model=2, device="cuda", timeout=400)
        except Exception as e:      # re-raised below
            res2["res"] = e
    th = threading.Thread(target=run_two)
    th.start()
    recs, dry_s = fm_dryrun_records()
    th.join()
    if isinstance(res2["res"], Exception):
        raise res2["res"]
    two = res2["res"]
    t2 = time.perf_counter() - t0
    out = {"world4_s": t4, "world2_s": t2,
           "reduced": {"1x2": fm_check(zoo, "2", two, want),
                       "2x2": fm_check(zoo, "4", four["res"], want)}}
    for key in ("granite", "mamba2"):
        ranks = [r[key] for r in two]
        if not all(r["finite"] for r in ranks):
            fail(f"10(b) {key}: non-finite outputs")
        out[key] = {**{k: v for k, v in ranks[0].items() if k != "tokens"},
                    "per_rank": [{k: r[k] for k in r if k.endswith("_ms")
                                  or k.startswith("peak")} for r in ranks]}
    # layer 0's kernel calls on a rank's slice at model=2: B6 on Q (4096
    # -> 16 of 32 heads) and K/V (4 of 8 heads) at forward_full's T and
    # decode_step's; B5 on 40 of mamba2's 80 heads; B2 on the rank's
    # in-projection columns (z and x of its heads, B and C whole, its dt)
    g, m = GRANITE_FULL, MAMBA_FULL
    b6_shapes = [f"T={T} 4096->{w} n={g['adapters'] + 1} r={g['rank']}"
                 for T in (g["B"] * g["S"], g["B"]) for w in (2048, 512, 512)]
    b5_shapes = [f"({m['B']}, {m['S']}, 40, 64) N=128"]
    b2_shapes = [f"T={m['B'] * m['S']} d=2560 out=5416 n=2 r=32"]
    plain = {}
    for i, x in enumerate(two):
        for key, kern, tol, shapes in (
                ("granite", "b6", TOL["bfloat16"], b6_shapes),
                ("mamba2", "b5", TOL["float32"], b5_shapes),
                ("mamba2", "b2", TOL["bfloat16"], b2_shapes)):
            e = fm_plain_check(f"10(b) {key} rank {i}: {kern.upper()}",
                               x[key][f"{kern}_vs_plain"], tol, shapes)
            plain[kern] = max(plain.get(kern, 0.0), e)
    out["vs_plain"] = plain
    gr = out["granite"]
    for r in (x["granite"] for x in two):
        n = 3 * r["layers"]             # Q, K and V of every layer
        if (r["forward_launches_B6"], r["decode_launches_B6_per_step"]) \
                != (n, n):
            fail(f"10(b) granite: B6 {r['forward_launches_B6']} a forward, "
                 f"{r['decode_launches_B6_per_step']} a decode step, not "
                 f"{n} and {n} on each rank")
        if r["tokens"] != two[0]["granite"]["tokens"]:
            fail("10(b) granite: the ranks decoded different tokens")
    for r in (x["mamba2"] for x in two):
        if (r["forward_launches_B5"], r["adapted_launches_B2"]) != \
                (r["layers"], r["layers"]):
            fail(f"10(b) mamba2: B5 {r['forward_launches_B5']}, B2 "
                 f"{r['adapted_launches_B2']} on a rank, not "
                 f"{r['layers']} each")
        if not r["row0_unchanged"]:
            fail("10(b) mamba2: the adapter changed row 0 (base weights)")
    trains = [r["train"] for r in four["res"]]
    for k in ("loss", "grad_norm"):
        if len({r[k] for r in trains}) != 1 or not np.isfinite(trains[0][k]):
            fail(f"10(b) train: {k} {[r[k] for r in trains]} differs across "
                 "ranks or is not finite")
    out["train"] = {**trains[0], "step_ms_per_rank":
                    [r["step_ms"] for r in trains],
                    "peak_gb_per_rank": [r["peak_gb"] for r in trains]}
    mb = out["mamba2"]
    tr = out["train"]
    print(f"  10(b) granite-3.2-8b full width, model=2, 4 rank-32 adapters: "
          f"forward_full 2 x 1024 {gr['forward_ms']:.1f} ms (B6 "
          f"{gr['forward_launches_B6']} a rank), decode_step "
          f"{gr['decode_ms']:.1f} ms (B6 {gr['decode_launches_B6_per_step']:.0f} "
          f"a rank), weights {gr['weights_bytes'] / 1e9:.2f} GB and peak "
          f"{gr['peak_gb']:.2f} GB a rank", flush=True)
    print(f"  10(b) mamba2-2.7b {FM_MAMBA_LAYERS} layers, model=2: "
          f"forward_full 2 x 2048 {mb['forward_ms']:.1f} ms (B5 "
          f"{mb['forward_launches_B5']} a rank), adapted "
          f"{mb['adapted_forward_ms']:.1f} ms (B2 {mb['adapted_launches_B2']} "
          f"a rank), peak {mb['peak_gb']:.2f} GB a rank", flush=True)
    print(f"  10(b) TP + ZeRO-1 train step, granite widths x "
          f"{FM_TRAIN['layers']} layers, B {FM_TRAIN['B']} x S "
          f"{FM_TRAIN['S']} at (2, 2): {tr['step_ms']:.1f} ms (ranks "
          + ", ".join(f"{x:.1f}" for x in tr["step_ms_per_rank"])
          + f"), loss {tr['loss']:.4f}, grad norm {tr['grad_norm']:.4f}, "
          f"peak {max(tr['peak_gb_per_rank']):.2f} GB a rank", flush=True)
    print(f"  10(b) layer 0 on each rank's slice, kernel vs plain (of max "
          f"|plain|): B6 {plain['b6']:.3e} at {b6_shapes[0]}, "
          f"{b6_shapes[1]} and T={g['B']} (tol {TOL['bfloat16']}); B5 "
          f"{plain['b5']:.3e} at {b5_shapes[0]} (tol {TOL['float32']}); B2 "
          f"{plain['b2']:.3e} at {b2_shapes[0]} (tol {TOL['bfloat16']})",
          flush=True)
    print(f"  world of 4 ranks {t4:.1f} s (with the unsharded runs), world "
          f"of 2 ranks {t2:.1f} s", flush=True)
    out["dryrun"] = fm_dryrun(tp_summary, [x["granite"]["weights_bytes"]
                                           for x in two], recs, dry_s)
    return out


# ---------------------------------------------------------------------------
# phase 11: the step audit (Pass A, repro_torch.analysis.step_audit)
# ---------------------------------------------------------------------------
# (b) and (c): the engines of phase 3 audited at the end of their serve
# (their full-width weights live on the card only then), each on the
# batches of a short untimed capture serve on it
AUDIT_ARCHS = ("granite-3.2-8b", "mamba2-2.7b")


def audit_served(torch, eng, arch):
    """Phase 11 (b)/(c), run inside phase 3: Pass A on ``eng`` (phase 3's
    full-width bf16 engine at 1x1, after its timed serve) over the
    batches of a short untimed capture serve on it
    (``step_audit.capture_serve``, its requests on the engine's "eval"
    adapter): no violation, ``set_sync_debug_mode("error")`` on and
    silent, the traced step launching B1 and the fused B2 once per
    attention layer and B3 and the one-pair B2 once per SSM layer; its
    memory record and A5's allowed findings printed."""
    from repro_torch.analysis import step_audit as sa
    r = eng.runner
    t0 = time.perf_counter()
    steps0 = r.call_counts["mixed_step"]
    batches, fetches = sa.capture_serve(eng, adapter="eval")
    n_steps = r.call_counts["mixed_step"] - steps0
    res = sa.audit_engine(eng, batches, fetches, n_steps, arch=arch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want = {k: n for k, n in (("ragged_paged_attention", r.La),
                              ("ragged_grouped_lora_qkv", r.La),
                              ("ragged_grouped_lora", r.Ls),
                              ("ragged_ssd_chunk_scan", r.Ls)) if n}
    print(f"  [11{'b' if r.La else 'c'}] step audit of this engine: "
          f"{len(batches)} batches captured, {n_steps} mixed steps; the "
          f"traced step's launches {res.launches}; donated {res.donated}; "
          f"sync debug mode 'error' "
          f"{'on' if res.sync_guarded else 'OFF'}; memory "
          + ", ".join(f"{k} {v / 1e6:.3f} MB" for k, v in res.memory.items())
          + f"; {seconds:.1f} s", flush=True)
    if res.allowed:
        print(f"  [11] A5 flags {len(res.allowed)} copies on its allow-list "
              f"(first: {res.allowed[0]}); the list: "
              f"{dict(sa.ALLOWED_UPCASTS)}", flush=True)
    if r.Ls and not res.allowed:
        print("  [11] A5 flagged no float32 copy of out_proj", flush=True)
    if res.violations or res.launches != want or not res.sync_guarded:
        fail(f"phase 11 audit of {arch}: violations {res.violations}, "
             f"launches {res.launches} (want {want}), sync guard "
             f"{res.sync_guarded}")
    return {"seconds": seconds, "batches": len(batches), "steps": n_steps,
            "launches": res.launches, "donated": res.donated,
            "memory": res.memory, "allowed": res.allowed,
            "sync_async_identical": res.sync_async_identical}


def step_audit_phase(mp):
    """Phase 11: (a) ``python -m repro_torch.analysis --device cuda
    --skip-lint`` over every config × mesh (the 2x4 mesh in one world of
    8 ranks sharing the card): every step clean, every fingerprint equal
    to the goldens made on the CPU; then (b)/(c)'s records from phase
    3."""
    from repro_torch.configs import list_archs
    out_dir = ROOT / "results" / "torch"
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--device", "cuda", "--skip-lint", "--out",
                          str(out_dir)],
                         cwd=ROOT, env={**os.environ,
                                        "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    for line in run.stdout.splitlines():
        print("  " + line, flush=True)
    if run.returncode:
        fail(f"python -m repro_torch.analysis --device cuda exited "
             f"{run.returncode}:\n{run.stderr[-6000:]}")
    if "in one world of 8 ranks" not in run.stdout:
        fail("the 2x4 audit did not run in one world of 8 ranks")
    n = 2 * len(list_archs())
    with open(out_dir / "analysis_audit.jsonl") as f:
        recs = [json.loads(line) for line in f][-n:]
    if len(recs) != n or not all(r["ok"] and not r["fingerprint_drift"]
                                 for r in recs):
        fail(f"phase 11(a): {n} clean records expected, got {recs}")
    table = {f"{r['arch']} [{r['mesh']}]": {
        "donated": r["donated"], "counts": r["fingerprint"]["counts"],
        "temp_mb": r["memory"].get("temp_size_bytes", 0) / 1e6}
        for r in recs}
    for k, v in table.items():
        print(f"  {k}: donated {v['donated']}, collectives {v['counts']}, "
              f"temp {v['temp_mb']:.3f} MB", flush=True)
    served = {a: mp[a]["step_audit"] for a in AUDIT_ARCHS}
    print(f"  [11a] {n} steps audited on the card in {seconds:.1f} s, no "
          "violation, no drift from the CPU goldens; [11b/c] "
          + ", ".join(f"{a} {v['seconds']:.1f} s" for a, v in served.items())
          + " (inside phase 3)", flush=True)
    return {"seconds": seconds, "records": table, "served": served}


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
    phase_s = {}

    def phase(name: str) -> None:
        """Close the running phase's timer and print the next one's title
        with the seconds since the start."""
        now = time.perf_counter() - t_start
        if phase_s:
            last = next(reversed(phase_s))
            phase_s[last] = now - phase_s[last]
        phase_s[name] = now
        print(f"{name} ({now:.1f} s)", flush=True)
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

    phase("[1] build")
    t0 = time.perf_counter()
    _, log = build.build()
    build.load()
    print(f"  kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    analyzer(ROOT)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip(), flush=True)

    phase("[2] kernels vs plain")
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
    lora_r8 = check_lora_rank8(torch, cfgs, timer, gen)
    lora_edges = check_lora_edges(torch, cfgs, gen)
    scan = check_ssd_scan(torch, timer, gen)
    scan_edges = check_scan_edges(torch, gen)
    edges = check_bench_edges(torch)
    moe_layer = check_moe(torch, cfgs, timer)
    seq_kernels = check_sequential_kernels(torch, cfgs, timer)
    del timer
    torch.cuda.empty_cache()

    phase("[3] main path, full width")
    mp = {}
    for arch in ("granite-3.2-8b", "mamba2-2.7b", "zamba2-2.7b",
                 *DENSE_ARCHS, *MOE_VLM_ARCHS, ENCDEC_ARCH):
        print(f" [3] {arch}", flush=True)
        t0 = time.perf_counter()
        mp[arch] = main_path(torch, arch,
                             profile=arch != "zamba2-2.7b",
                             long=arch == "starcoder2-3b",
                             num_layers=PHASE3_LAYERS.get(arch, 0),
                             sequential=arch in SEQ_ARCHS)
        mp[arch]["seconds"] = time.perf_counter() - t0
        print(f"  {arch}: {mp[arch]['seconds']:.1f} s", flush=True)

    phase("[4] parity, reduced fp32, card vs CPU")
    par = {arch: parity(torch, arch)
           for arch in ("granite-3.2-8b", "mamba2-2.7b", "zamba2-2.7b",
                        *DENSE_ARCHS[:3], *MOE_VLM_ARCHS, ENCDEC_ARCH)}
    # past the reduced starcoder2's 128-token window
    par["starcoder2-3b"] = parity(torch, "starcoder2-3b", prompt_len=150)
    par["slot_rank"] = slot_rank_card(torch)
    par["granite-3.2-8b/fleet"] = fleet_parity(torch)
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

    phase("[5] kernel bench entry point, full width")
    bres, blaunch, bsec = bench_path(torch)

    phase("[6] serving launcher and 2-replica fleet, full width")
    tier = serving_tier(torch)
    tier_launches = {
        name: {**{f"launcher_p{p}": r["launches"][name]
                  for p, r in tier["launcher"].items()},
               **{f"fleet_{k}": tier["fleet"][k]["launches"][name]
                  for k in ("affinity", "round_robin", "drain")}}
        for name in ("ragged_paged_attention", "ragged_grouped_lora_qkv")}

    phase("[7] paper benches and examples")
    reset_counts()
    benches = paper_benches(torch)
    bench_launches = {name: fn.launches for name, fn in counted().items()}
    print("  phase 7 launches: " + ", ".join(
        f"{k} {v}" for k, v in bench_launches.items()), flush=True)
    for name in SERVING + ("paged_attention", "alora_qkv"):
        if bench_launches[name] == 0:
            fail(f"phase 7 never launched {name}")

    phase("[8] full-sequence model and training, full width")
    full = full_model_path(torch)

    phase("[9] the sharded mixed step, ranks sharing the card")
    p3 = {a: {"outputs": mp[a].pop("tp_outputs"), "num_layers":
              mp[a]["num_layers"], **{k: mp[a][k] for k in (
                  "eval_cache_hits", "weights_gb", "step_ms_mean")}}
          for a in TP_ARCHS[:2]}
    tp = sharded_step(torch, p3)

    phase("[10] the sharded full-sequence model and training")
    fm = sharded_model_path(torch, tp)

    phase("[11] the step audit (Pass A) on the card")
    audit = step_audit_phase(mp)

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
            edge_rel_err=attn_edges,
            launches_serving_tier=tier_launches["ragged_paged_attention"]),
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
            edge_rel_err=lora_edges,
            rank8_all_rows={k: {f: v for f, v in e.items()
                                if f not in ("bytes", "ops")}
                            for k, e in lora_r8.items()},
            launches_serving_tier=tier_launches["ragged_grouped_lora_qkv"]),
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
                    "mamba2_N128",
                    others=("zamba2_N64", "reduced_ssm_N16")),
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
    for entry in kernels:
        entry["launches_paper_benches"] = bench_launches[entry["name"]]
        if entry["name"] in SERVING:
            # phase 9: each rank's launches, full width at model=2
            entry["launches_sharded_per_rank"] = {
                key: tp[key]["launches_per_rank"][0][entry["name"]]
                for key in ("granite", "mamba2")}
        if entry["name"] == "ssd_chunk_scan":
            # a main path since phase 8: mamba2-2.7b's no-grad forward_full
            mf = full["mamba2"]
            entry.update(
                launches=mf["forward_launches_B5"], launches_bench=blaunch[
                    "ssd_chunk_scan"],
                launches_per_step=mf["forward_launches_B5"],
                per="mamba2-2.7b forward_full",
                path="mamba2-2.7b forward_full (no grad), one per layer",
                launches_forward_full_under_grad=mf[
                    "grad_forward_launches_B5"],
                forward_full={k: mf[k] for k in (
                    "scan_shape", "layer0_rel_err_y", "layer0_rel_err_state",
                    "layer0_ms", "layer0_plain_ms", "layer0_bound_ms",
                    "layer0_bound_by", "forward_ms")})
        if entry["name"] == "ragged_grouped_lora":
            # phase 8: mamba2-2.7b's adapted no-grad forward_full
            ad = full["mamba2"]["adapted"]
            entry.update(
                launches_forward_full=ad["launches_B2"],
                forward_full={k: v for k, v in ad.items()
                              if k != "launches_B2"})
        sharded = {
            "alora_qkv": {
                "granite_forward_full_model2": fm["granite"][
                    "forward_launches_B6"],
                "granite_decode_step_model2": fm["granite"][
                    "decode_launches_B6_per_step"]},
            "ssd_chunk_scan": {"mamba2_forward_full_model2": fm["mamba2"][
                "forward_launches_B5"]},
            "ragged_grouped_lora": {
                "mamba2_adapted_forward_full_model2": fm["mamba2"][
                    "adapted_launches_B2"]}}.get(entry["name"])
        if sharded is not None:
            # phase 10: each rank's launches in the sharded full model,
            # and layer 0's calls on a rank's slice against the plain
            # version (worst of max |err| / max |plain|)
            entry["launches_sharded_model_per_rank"] = sharded
            entry["sharded_model_layer0_rel_err"] = fm["vs_plain"][{
                "alora_qkv": "b6", "ssd_chunk_scan": "b5",
                "ragged_grouped_lora": "b2"}[entry["name"]]]
        if entry["name"] == "alora_qkv":
            gf = full["granite"]
            entry.update(
                launches_forward_full=gf["forward_launches_B6"],
                launches_decode_step_per_step=gf[
                    "decode_launches_B6_per_step"],
                full_model={k.split("/", 1)[1]: {
                    f: v for f, v in r.items() if f != "finite"}
                    for k, r in full["b6"].items()})
    phase("end")
    phase_s.pop("end")
    print("  seconds per phase: " + ", ".join(
        f"{k.split(' ')[0]} {v:.1f}" for k, v in phase_s.items()), flush=True)
    print(json.dumps({"main_path": mp, "parity": par, "moe_layer": moe_layer,
                      "sequential_kernels": seq_kernels,
                      "bench": bres, "serving_tier": tier,
                      "paper_benches": benches, "full_model": full,
                      "sharded_step": tp, "sharded_model": fm,
                      "step_audit": audit,
                      "bench_seconds": bsec, "card": card,
                      "phase_seconds": phase_s,
                      "seconds": time.perf_counter() - t_start}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
