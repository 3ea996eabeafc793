"""Ragged grouped-LoRA delta: the hand-written Hopper kernel that
replaces the reference's TPU kernel
``repro/kernels/ragged_lora.py::ragged_grouped_lora`` (and its padding
wrapper ``ragged_grouped_lora_padded``), with its plain PyTorch version
beside it.

  delta[t] = (x[t] @ A[s_t]) @ B[s_t]   if s_t > 0 and s_t in active_slots
           = 0                          otherwise

``active_slots`` is the step's ascending, 0-padded list of adapter slots
its tokens reference; slot 0 is the permanently-zero adapter.  The CUDA
source (``repro_torch/csrc/ragged_lora.cu``) runs it SGMV-style in two
kernels over tiles of 16 packed rows: a shrink split over d into an fp32
scratch, then an expand whose prologue sums the splits and rounds
``x @ A`` once to x's dtype.  It masks its own ragged edges, so no
padding of T or of the output widths is needed.  :func:`plan` gives the
launch (grids, d split, scratch) from the shapes alone.

Two entry points share the kernels:

- ``ragged_grouped_lora(x, a, b, adapter_idx, active_slots)``: one delta
  (the SSM layers' fused input projection);
- ``ragged_grouped_lora_qkv(x, (aq, bq), (ak, bk), (av, bv), ...)``: the
  three deltas of an attention layer's Q/K/V in one pair of launches
  (the shrink reads x once against the three A stacks).

Each sends a CUDA tensor to the kernels and a CPU tensor to
:func:`ragged_grouped_lora_ref` (three calls for the fused entry), and
counts its calls that launch the kernels in ``.launches``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import build

# the launch plan; TILE_ROWS, OUT_TILE, MAX_PAIRS, SPLIT_STEP and
# SPLIT_RANGE[1] are the CUDA source's kRows, kOutTile, kMaxPairs,
# kSplitStep and kMaxSplit
TILE_ROWS = 16            # packed rows per token tile (the mma M)
OUT_TILE = 128            # expand: output columns per block
MAX_PAIRS = 3             # (A, B) pairs per launch: Q, K and V
SPLIT_STEP = 64           # the shrink's d split is a multiple of this,
SPLIT_RANGE = (128, 512)  # within these bounds
TARGET_BLOCKS = 132       # shrink blocks the split aims at (the SMs)
RANKS = (8, 16, 32, 64, 128, 256)   # the adapter pool's pow2 rank buckets
ALIGN = 8                 # d and each output width: whole 16-byte rows

Pair = Tuple[torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class Plan:
    """How the two kernels cover a call, from the shapes alone; the
    launch takes every field.  The CUDA source sizes each block's shared
    memory from the dtype and rank."""
    split: int                          # d columns per shrink block
    shrink_grid: Tuple[int, int, int]   # (token tiles, splits, pairs)
    expand_grid: Tuple[int, int]        # (output tiles of all pairs, tiles)
    tile0: Tuple[int, ...]              # each pair's first output tile
    scratch: Tuple[int, int, int]       # fp32 (splits, T, pairs * r)


@functools.lru_cache(maxsize=256)
def plan(T: int, d: int, r: int, out_widths: Tuple[int, ...],
         K: int) -> Plan:
    """The launch of one call with x (T, d), rank-``r`` stacks, one
    output per width of ``out_widths`` and an active-slot list of length
    ``K`` (the grid does not depend on it: a tile finds its slots on the
    card).  The d split is d over the number of splits that would make
    ~132 shrink blocks with the step's token tiles and pairs, rounded up
    to a multiple of 64 and held within [128, 512].  Raises
    ``ValueError`` for a shape the kernels do not take."""
    if r not in RANKS:
        raise ValueError(f"rank {r}: the kernel takes the pool's rank "
                         f"buckets {RANKS}")
    if d <= 0 or d % ALIGN:
        raise ValueError(f"d {d} must be a positive multiple of {ALIGN}")
    if not 1 <= len(out_widths) <= MAX_PAIRS \
            or any(o <= 0 or o % ALIGN for o in out_widths):
        raise ValueError(f"output widths {out_widths}: 1 to {MAX_PAIRS}, "
                         f"each a positive multiple of {ALIGN}")
    if T < 0 or K < 0:
        raise ValueError(f"T {T} and K {K} must not be negative")
    tiles = -(-T // TILE_ROWS)
    pairs = len(out_widths)
    want = -(-TARGET_BLOCKS // max(1, tiles * pairs))
    per = -(-d // want)                       # d columns per wanted split
    lo, hi = SPLIT_RANGE
    split = min(hi, max(lo, -(-per // SPLIT_STEP) * SPLIT_STEP))
    tile0, n = [], 0
    for o in out_widths:
        tile0.append(n)
        n += -(-o // OUT_TILE)
    splits = -(-d // split)
    return Plan(split=split, shrink_grid=(tiles, splits, pairs),
                expand_grid=(n, tiles), tile0=tuple(tile0),
                scratch=(splits, T, pairs * r))


def ragged_grouped_lora_ref(x: torch.Tensor, a_stack: torch.Tensor,
                            b_stack: torch.Tensor, adapter_idx: torch.Tensor,
                            active_slots: torch.Tensor) -> torch.Tensor:
    """Plain version (a port of the reference's
    ``ragged_grouped_lora_ref``): a masked product per active slot,
    summed in slot order in x's dtype.

    x: (T, d); a_stack: (S+1, d, r); b_stack: (S+1, r, out); adapter_idx:
    (T,) int32; active_slots: (K,) int32.  Returns (T, out).

    It agrees with the dense ``models.layers.lora_delta`` within
    rounding: inactive slots add exact zeros, but each product may sum in
    another order."""
    acc = torch.zeros((x.shape[0], b_stack.shape[-1]), dtype=x.dtype,
                      device=x.device)
    for s in active_slots.tolist():
        if s <= 0:                    # slot 0 is the zero adapter
            continue
        sel = (adapter_idx == s)[:, None].to(x.dtype)
        acc = acc + ((x * sel) @ a_stack[s]) @ b_stack[s]
    return acc


def _check(x, pairs: Sequence[Pair], adapter_idx, active_slots) -> Plan:
    """Device, dtype, contiguity, alignment and shape checks of one
    launch, and its plan."""
    dev = x.device
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: the kernel takes float32 or "
                        "bfloat16")
    named = [("x", x, x.dtype), ("adapter_idx", adapter_idx, torch.int32),
             ("active_slots", active_slots, torch.int32)]
    for i, (a, b) in enumerate(pairs):
        named += [(f"a_stack[{i}]", a, x.dtype),
                  (f"b_stack[{i}]", b, x.dtype)]
    for name, t, want in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 2 or any(a.dim() != 3 or b.dim() != 3 for a, b in pairs):
        raise ValueError("expected x (T,d), a_stack (S+1,d,r) and b_stack "
                         "(S+1,r,out)")
    T, d = x.shape
    n, _, r = pairs[0][0].shape
    for a, b in pairs:
        if a.shape != (n, d, r) or b.shape[:2] != (n, r):
            raise ValueError(f"shape mismatch: x {tuple(x.shape)}, a_stack "
                             f"{tuple(a.shape)}, b_stack {tuple(b.shape)}; "
                             "every pair takes one slot count and rank")
    if adapter_idx.shape != (T,) or active_slots.dim() != 1:
        raise ValueError("adapter_idx must be (T,), active_slots (K,)")
    if any(t.data_ptr() % 16 for _, t, _ in named[:1] + named[3:]):
        raise ValueError("x and the stacks must be 16-byte aligned")
    return plan(T, d, r, tuple(b.shape[-1] for _, b in pairs),
                active_slots.shape[0])


def _launch(x, pairs: Sequence[Pair], adapter_idx, active_slots
            ) -> Tuple[torch.Tensor, ...]:
    """Check, plan and launch both kernels over ``pairs``; returns one
    delta per pair."""
    p = _check(x, pairs, adapter_idx, active_slots)
    T, d = x.shape
    n, _, r = pairs[0][0].shape
    outs = tuple(torch.empty((T, b.shape[-1]), dtype=x.dtype,
                             device=x.device) for _, b in pairs)
    if T == 0:
        return outs
    part = torch.empty(p.scratch, dtype=torch.float32, device=x.device)
    ptrs, widths, tile0 = [], [], []
    for i in range(MAX_PAIRS):
        if i < len(pairs):
            a, b = pairs[i]
            ptrs += [a.data_ptr(), b.data_ptr(), outs[i].data_ptr()]
            widths.append(b.shape[-1])
            tile0.append(p.tile0[i])
        else:
            ptrs += [None, None, None]
            widths.append(0)
            tile0.append(0)
    tiles, n_split, _ = p.shrink_grid
    err = build.load().ragged_grouped_lora(
        x.data_ptr(), *ptrs, adapter_idx.data_ptr(), active_slots.data_ptr(),
        part.data_ptr(), T, d, r, *widths, len(pairs), n,
        active_slots.shape[0], p.split, n_split, tiles, p.expand_grid[0],
        *tile0, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ragged_grouped_lora")
    return outs


def ragged_grouped_lora(x: torch.Tensor, a_stack: torch.Tensor,
                        b_stack: torch.Tensor, adapter_idx: torch.Tensor,
                        active_slots: torch.Tensor) -> torch.Tensor:
    """Shapes as in :func:`ragged_grouped_lora_ref`.  On a CUDA tensor
    the kernels run: fp32 accumulation, ``x @ A`` rounded once to x's
    dtype (as the TPU kernel does), the expand accumulated in fp32 and
    rounded once."""
    if x.device.type == "cpu":
        return ragged_grouped_lora_ref(x, a_stack, b_stack, adapter_idx,
                                       active_slots)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    build.no_backward("ragged_grouped_lora", x, a_stack, b_stack)
    (out,) = _launch(x, ((a_stack, b_stack),), adapter_idx, active_slots)
    if x.shape[0]:
        ragged_grouped_lora.launches += 1
    return out


ragged_grouped_lora.launches = 0


def ragged_grouped_lora_qkv(x: torch.Tensor, q: Pair, k: Pair, v: Pair,
                            adapter_idx: torch.Tensor,
                            active_slots: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The Q, K and V deltas of one attention layer: each of ``q``,
    ``k``, ``v`` is an (a_stack, b_stack) pair of one slot count and
    rank, shapes as in :func:`ragged_grouped_lora_ref`.  On a CUDA tensor
    one pair of kernel launches computes all three (numbers as
    :func:`ragged_grouped_lora`'s); on a CPU tensor the plain version
    runs once per pair."""
    pairs = (q, k, v)
    if x.device.type == "cpu":
        return tuple(ragged_grouped_lora_ref(x, a, b, adapter_idx,
                                             active_slots) for a, b in pairs)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    build.no_backward("ragged_grouped_lora_qkv", x,
                      *(t for pair in pairs for t in pair))
    outs = _launch(x, pairs, adapter_idx, active_slots)
    if x.shape[0]:
        ragged_grouped_lora_qkv.launches += 1
    return outs


ragged_grouped_lora_qkv.launches = 0
