"""Fused aLoRA QKV projection: the hand-written Hopper kernel that
replaces the reference's TPU kernel ``repro/kernels/alora_qkv.py::alora_qkv``
(and its padding wrapper ``repro.kernels.ops.alora_qkv_op``), with its
plain PyTorch version beside it.

  out[t] = x[t] @ W + (x[t] @ A[idx_t]) @ B[idx_t]   if 1 <= idx_t < n
  out[t] = x[t] @ W                                   otherwise

Adapter 0 is the zero adapter (base-model tokens and the tokens before
an aLoRA request's invocation): it is skipped whatever ``A[0]`` holds.
The CUDA source (``repro_torch/csrc/alora_qkv.cu``) runs a shrink
(``x @ A`` per token tile and adapter, on tensor cores), the tile
kernel (the base product on ``wgmma`` in bfloat16 or 3xTF32 ``mma.sync``
in float32, fed by TMA, with the delta as extra k steps) and, when
:func:`plan` splits d, a pass that sums the splits.  It masks its own
edges, so T and the output width need no padding.

``alora_qkv`` sends a CUDA tensor to the kernels and a CPU tensor to
:func:`alora_qkv_ref`; ``alora_qkv.launches`` counts calls that launched
them.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import build

MAX_RANK = 256            # the largest rank the kernels take
RANK_STEP = 16            # x @ A is staged with its rank padded to this
ALIGN = 8                 # d and the output width: 16-byte rows
ROW_BYTES = 128           # a swizzled shared row, the TMA box's width
SHRINK_ROWS = 64          # the shrink's token tile (the CUDA kShrinkRows)
SHRINK_MAX_KC = 256       # the shrink's d split: at most this ...
SHRINK_SMEM = 110 * 1024  # ... and within this shared memory
BYTES_BOUND_T = 128       # T at or below: W's bytes bound the product
SMS = 132                 # H100 SXM
PAIR_SMEM = 113 * 1024    # a tile block's share when two share an SM
MAX_SMEM = 227 * 1024     # a block's shared memory, at most
TILES = {torch.bfloat16: (192, 128), torch.float32: (128,)}  # BN choices
REDUCE_THREADS = 256


@dataclass(frozen=True)
class Plan:
    """How the kernels cover a call, from the shapes alone; the launch
    takes every field."""
    rp: int                      # rank padded to 16 (the scratch width)
    bm: int                      # token rows a tile (64 per warpgroup)
    bn: int                      # output columns a tile
    stages: int                  # TMA ring stages
    split: int                   # d splits of the tile grid
    ksteps: int                  # 128-byte k steps over d
    grid: Tuple[int, int, int]   # (token tiles, output tiles, splits)
    smem: int                    # the tile block's dynamic shared memory
    shrink_kc: int               # d columns a shrink block
    shrink_split: int            # the shrink's d splits
    shrink_grid: Tuple[int, int, int]  # (64-row tiles, splits, n - 1)
    shrink_smem: int
    xa_blocks: int               # the pass summing the shrink's splits
    reduce_blocks: int           # 0: no split of the tile grid to sum


def tile_smem(bm: int, bn: int, stages: int) -> int:
    """The tile block's shared memory as the CUDA source lays it out: 1 KB
    of alignment, the stages' x and W tiles (128-byte rows), two
    mbarriers a stage, the rows' adapters and the adapter list."""
    return 1024 + stages * (bm + bn) * ROW_BYTES + stages * 16 + bm * 8 + 16


def shrink_smem(es: int, kc: int, rp: int) -> int:
    """The shrink block's: the tile's x split and its adapter's A rows of
    it, padded."""
    px = 8 if es == 2 else 4
    return (SHRINK_ROWS * (kc + px) + kc * (rp + 8)) * es


@functools.lru_cache(maxsize=256)
def plan(T: int, d: int, out: int, r: int, n: int,
         dtype: torch.dtype) -> Plan:
    """The launch of one call with x (T, d), W (d, out) and ``n`` stacked
    rank-``r`` adapters.  Tiles of 64 (T <= 64) or 128 token rows.  At
    T <= 128 the bf16 product is bound by W's bytes: 128-column tiles and
    d split until at least 132 blocks stream W, two blocks to an SM,
    their fp32 partials summed in split order; float32 (bound by its
    operations, one block to an SM) splits d only as far as whole waves
    allow.  Above, whole-d tiles of the width (192 or 128 in bf16) that
    fills the 132 SMs' waves best.  The shrink takes 64-row token tiles
    and splits d into runs of at most 256 columns that fit its shared
    memory; a pass sums its splits in order and rounds once.  Raises
    ``ValueError`` for a shape the kernels do not take."""
    if dtype not in TILES:
        raise ValueError(f"dtype {dtype}: the kernel takes float32 or "
                         "bfloat16")
    if T < 1 or d < ALIGN or out < ALIGN or d % ALIGN or out % ALIGN:
        raise ValueError(f"T={T} must be positive, d={d} and out={out} "
                         f"positive multiples of {ALIGN}")
    if not 0 < r <= MAX_RANK or n < 1:
        raise ValueError(f"rank {r} outside 1..{MAX_RANK}, or n={n} < 1")
    es = 2 if dtype == torch.bfloat16 else 4
    epb = ROW_BYTES // es
    rp = -(-r // RANK_STEP) * RANK_STEP
    bm = 64 if T <= 64 else 128
    mt = -(-T // bm)
    ksteps = -(-d // epb)
    if T <= BYTES_BOUND_T and dtype == torch.bfloat16:
        bn = 128
        nt = -(-out // bn)
        split = max(1, min(ksteps, -(-SMS // (mt * nt))))
        budget = PAIR_SMEM
    elif T <= BYTES_BOUND_T:
        # float32: the operations bound it, and a block's operand splits
        # leave registers for one block per SM: whole waves
        bn = 128
        nt = -(-out // bn)
        split = max(1, min(ksteps, SMS // (mt * nt)))
        budget = MAX_SMEM
    else:
        def score(bn):
            ctas = mt * -(-out // bn)
            return (ctas / (-(-ctas // SMS) * SMS), -(-(-out // bn) * bn),
                    bn)
        bn = max(TILES[dtype], key=score)
        nt = -(-out // bn)
        split = 1
        budget = MAX_SMEM
    stages = max(st for st in (2, 3, 4) if st == 2
                 or tile_smem(bm, bn, st) <= budget)
    kc = max(k for k in range(64, SHRINK_MAX_KC + 1, 64)
             if k == 64 or shrink_smem(es, k, rp) <= SHRINK_SMEM)
    kc = min(kc, -(-d // 64) * 64)
    xs = -(-d // kc)
    xa_blocks = min(-(-(T * rp // 2) // REDUCE_THREADS), SMS * 8)
    reduce_blocks = 0 if split == 1 else \
        min(-(-(T * out // 4) // REDUCE_THREADS), SMS * 8)
    return Plan(rp=rp, bm=bm, bn=bn, stages=stages, split=split,
                ksteps=ksteps, grid=(mt, nt, split),
                smem=tile_smem(bm, bn, stages), shrink_kc=kc,
                shrink_split=xs, shrink_grid=(-(-T // SHRINK_ROWS), xs, n - 1),
                shrink_smem=shrink_smem(es, kc, rp), xa_blocks=xa_blocks,
                reduce_blocks=reduce_blocks)


def alora_qkv_ref(x: torch.Tensor, w: torch.Tensor, a_stack: torch.Tensor,
                  b_stack: torch.Tensor,
                  adapter_idx: torch.Tensor) -> torch.Tensor:
    """Plain version (a port of ``repro/kernels/ref.py``'s
    ``alora_qkv_ref``): the base product plus a masked product per
    adapter 1..n-1, in x's dtype.

    x: (T, d); w: (d, out); a_stack: (n, d, r); b_stack: (n, r, out);
    adapter_idx: (T,) int32.  Returns (T, out)."""
    base = x @ w
    delta = torch.zeros_like(base)
    for i in range(1, a_stack.shape[0]):
        sel = (adapter_idx == i)[:, None].to(x.dtype)
        delta = delta + ((x * sel) @ a_stack[i]) @ b_stack[i]
    return base + delta


def _check(x, w, a_stack, b_stack, adapter_idx):
    named = (("x", x), ("w", w), ("a_stack", a_stack), ("b_stack", b_stack),
             ("adapter_idx", adapter_idx))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: the kernel takes float32 or "
                        "bfloat16")
    for name, t in named[1:4]:
        if t.dtype != x.dtype:
            raise TypeError(f"{name} dtype {t.dtype} differs from x's "
                            f"{x.dtype}")
    if adapter_idx.dtype != torch.int32:
        raise TypeError(f"adapter_idx must be int32, got {adapter_idx.dtype}")
    if x.dim() != 2 or w.dim() != 2 or a_stack.dim() != 3 \
            or b_stack.dim() != 3:
        raise ValueError("expected x (T,d), w (d,out), a_stack (n,d,r) and "
                         "b_stack (n,r,out)")
    T, d = x.shape
    out_dim = w.shape[1]
    n, _, r = a_stack.shape
    if w.shape[0] != d or a_stack.shape[1] != d \
            or b_stack.shape != (n, r, out_dim) or adapter_idx.shape != (T,):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, a_stack {tuple(a_stack.shape)}, "
                         f"b_stack {tuple(b_stack.shape)}, adapter_idx "
                         f"{tuple(adapter_idx.shape)}")
    if d % ALIGN or out_dim % ALIGN:
        raise ValueError(f"the kernel takes d and out multiples of {ALIGN}, "
                         f"got d={d}, out={out_dim}")
    if not 0 < r <= MAX_RANK:
        raise ValueError(f"rank {r} outside the kernel's 1..{MAX_RANK}")


def alora_qkv(x: torch.Tensor, w: torch.Tensor, a_stack: torch.Tensor,
              b_stack: torch.Tensor, adapter_idx: torch.Tensor) -> torch.Tensor:
    """Shapes as in :func:`alora_qkv_ref`.  On a CUDA tensor the kernels
    run: fp32 accumulation, ``x @ A`` rounded once to x's dtype (as the
    TPU kernel does), the output rounded once; d and the output width
    multiples of 8, rank at most 256.  On a CPU tensor the plain version
    does."""
    if x.device.type == "cpu":
        return alora_qkv_ref(x, w, a_stack, b_stack, adapter_idx)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    build.no_backward("alora_qkv", x, w, a_stack, b_stack)
    _check(x, w, a_stack, b_stack, adapter_idx)
    T, d = x.shape
    out_dim = w.shape[1]
    out = torch.empty((T, out_dim), dtype=x.dtype, device=x.device)
    if T == 0 or out_dim == 0:
        return out
    if d == 0:
        return out.zero_()
    _launch(x, w, a_stack, b_stack, adapter_idx, out)
    alora_qkv.launches += 1
    return out


alora_qkv.launches = 0


def _launch(x, w, a_stack, b_stack, adapter_idx, out) -> None:
    """Plan the call and launch its kernels into ``out``."""
    T, d = x.shape
    out_dim = w.shape[1]
    n, _, r = a_stack.shape
    p = plan(T, d, out_dim, r, n, x.dtype)
    f32 = dict(dtype=torch.float32, device=x.device)
    xa_part = torch.empty((p.shrink_split, T, p.rp) if n > 1 else (0,),
                          **f32)
    xa = torch.empty((T, p.rp) if n > 1 else (0,), dtype=x.dtype,
                     device=x.device)
    part = torch.empty((p.split, T, out_dim) if p.split > 1 else (0,),
                       **f32)
    lib = build.load()
    err = lib.alora_qkv(
        x.data_ptr(), w.data_ptr(), a_stack.data_ptr(), b_stack.data_ptr(),
        adapter_idx.data_ptr(), xa_part.data_ptr(), xa.data_ptr(),
        part.data_ptr(), out.data_ptr(), T, d, out_dim, n, r, p.rp, p.bm,
        p.bn, p.stages, p.split, p.ksteps, p.shrink_split, p.shrink_kc,
        p.xa_blocks, p.reduce_blocks, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "alora_qkv")
