"""Paged attention: the hand-written Hopper kernel that replaces the
reference's two TPU kernels of ``repro/kernels/paged_attention.py``,
with their plain PyTorch versions beside it.

- ``ragged_paged_attention``: one query row per packed token (decode
  singletons and prefill-chunk rows in the same launch); each attends
  over its own request's paged K/V through ``block_tables[req_rows[t]]``,
  causal to ``q_lens[t]``.
- ``paged_attention``: decode, one query per sequence over its own
  table row up to ``lengths[b]``.

Both take an optional sliding window and run an fp32 online softmax.
On the TPU the two share one body; here they share one pair of CUDA
kernels (``repro_torch/csrc/paged_attention.cu``): a tile kernel over
(query tile, KV head, context split) and a small kernel that merges the
splits of rows spanning more than one.  It reads only the positions
that are valid for some row of a tile, so padding table entries may be
any id.  :func:`plan` gives the launch (grid, tile size, scratch) from
the shapes alone.

Each wrapper sends a CUDA tensor to the kernel and a CPU tensor to its
plain version; nothing else selects between them.  Each counts its
calls that launch the kernels in ``.launches``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

# the launch plan
SPLIT = 256             # context tokens per split (grid.z): the CUDA
                        # source's kSplit, which it also cuts the span by
TILE_QUERY_ROWS = 64    # query rows (token x query head) per tile
# the head sizes it is built for: every attention config of the
# reference's registry, ported or not
HEAD_DIMS = (32, 64, 80, 96, 128, 160)


@dataclass(frozen=True)
class Plan:
    """How the kernel covers a call, from the shapes alone: one block
    per (packed row, KV head, context split); a block whose row heads no
    query tile, or whose split holds no valid position, exits at once.
    The CUDA source sizes each block's shared memory (asserting at
    compile time that it fits the card) from the dtype and hd."""
    grid: Tuple[int, int, int]      # (T, KV, splits)
    tile_rows: int                  # M = 64 // G packed rows per tile
    # fp32 scratch of rows spanning several splits: the accumulators
    # (T, H, splits, hd), then each split's max and sum (T, H, splits, 2);
    # None when there is one split
    partials: Optional[Tuple[int, int, int, int]]


@functools.lru_cache(maxsize=256)
def plan(T: int, H: int, KV: int, hd: int, bs: int, nb: int) -> Plan:
    """The launch of one call with q (T, H, hd), pools (NB, bs, KV, hd)
    and block tables (R, nb).  Raises ``ValueError`` for a shape the
    kernel does not take."""
    if KV <= 0 or H % KV:
        raise ValueError(f"H {H} is not a multiple of KV {KV}")
    G = H // KV
    if G > TILE_QUERY_ROWS:
        raise ValueError(f"G = H / KV = {G} query heads per KV head: the "
                         f"kernel takes G up to {TILE_QUERY_ROWS}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel is built for "
                         f"{HEAD_DIMS}")
    if bs <= 0 or bs & (bs - 1) or nb <= 0:
        raise ValueError(f"block size {bs} must be a power of two and the "
                         f"table width {nb} positive")
    splits = -(-nb * bs // SPLIT)
    return Plan(grid=(T, KV, splits), tile_rows=TILE_QUERY_ROWS // G,
                partials=(T, H, splits, hd) if splits > 1 else None)


def ragged_paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_tables: torch.Tensor,
                               req_rows: torch.Tensor, q_lens: torch.Tensor,
                               *, window: int = 0) -> torch.Tensor:
    """Plain version (a port of ``repro/kernels/ref.py``'s
    ``ragged_paged_attention_ref``): gathers each token's K/V rows and
    runs a masked fp32 softmax.

    q: (T, H, hd); k_pool/v_pool: (NB, bs, KV, hd); block_tables: (R, nb)
    int32; req_rows: (T,) int32; q_lens: (T,) int32 causal length per
    token (position + 1; 0 = masked row).  Returns (T, H, hd).  Rows with
    ``q_lens == 0`` hold a uniform average over masked keys — callers
    ignore them (the kernel writes zeros there)."""
    T, H, hd = q.shape
    _, bs, KV, _ = k_pool.shape
    nb = block_tables.shape[1]
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    bt = block_tables.long()[req_rows.long()]               # (T, nb)
    k = k_pool[bt].reshape(T, nb * bs, KV, hd).float()
    v = v_pool[bt].reshape(T, nb * bs, KV, hd).float()
    qr = q.reshape(T, KV, G, hd).float()
    s = torch.einsum("tkgd,tskd->tkgs", qr, k) * scale
    pos = torch.arange(nb * bs, device=q.device)[None, :]
    valid = pos < q_lens[:, None]
    if window > 0:
        valid = valid & (pos > q_lens[:, None] - 1 - window)
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("tkgs,tskd->tkgd", p, v)
    return out.reshape(T, H, hd).to(q.dtype)


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_tables: torch.Tensor,
                        lengths: torch.Tensor, *,
                        window: int = 0) -> torch.Tensor:
    """Plain version of decode attention (a port of
    ``repro/kernels/ref.py``'s ``paged_attention_ref``): the ragged plain
    version with one token per sequence, ``req_rows = arange(B)`` and
    ``q_lens = lengths`` (the two refs are the same function there).

    q: (B, H, hd); k_pool/v_pool: (NB, bs, KV, hd); block_tables: (B, nb)
    int32, padding entries any id; lengths: (B,) int32 valid tokens per
    sequence.  Returns (B, H, hd).  Rows with ``lengths == 0`` hold a
    uniform average over masked keys (the kernel writes zeros there)."""
    rows = torch.arange(q.shape[0], dtype=torch.int32, device=q.device)
    return ragged_paged_attention_ref(q, k_pool, v_pool, block_tables, rows,
                                      lengths, window=window)


def _check(q, k_pool, v_pool, block_tables, **index) -> Plan:
    """Device, dtype, contiguity, alignment and shape checks of one
    kernel call, and its launch plan; ``index`` holds the (T,) int32
    vectors by name.  One pass over the tensors: it runs on every
    launch, on the host, ahead of the kernel."""
    dev, dtype = q.device, q.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {dtype}: the kernel takes float32 or "
                        "bfloat16")
    i32 = torch.int32
    for name, t, want in (("q", q, dtype), ("k_pool", k_pool, dtype),
                          ("v_pool", v_pool, dtype),
                          ("block_tables", block_tables, i32),
                          *((n, t, i32) for n, t in index.items())):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3 or k_pool.dim() != 4 or block_tables.dim() != 2:
        raise ValueError("expected q (T,H,hd), pools (NB,bs,KV,hd) and "
                         "block_tables (R,nb)")
    T, H, hd = q.shape
    _, bs, KV, hd_k = k_pool.shape
    if v_pool.shape != k_pool.shape or hd_k != hd or H % KV:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    for name, t in index.items():
        if t.shape != (T,):
            raise ValueError(f"{name} must be ({T},), got {tuple(t.shape)}")
    if (q.data_ptr() | k_pool.data_ptr() | v_pool.data_ptr()) % 16:
        raise ValueError("q, k_pool and v_pool must be 16-byte aligned")
    return plan(T, H, KV, hd, bs, block_tables.shape[1])


def _launch(fn, p: Plan, q, k_pool, v_pool, block_tables, *index, window):
    """Run the C entry ``fn`` under plan ``p``: allocates the output and
    the split partials, launches, raises on a launch error."""
    T, H, hd = q.shape
    _, bs, KV, _ = k_pool.shape
    out = torch.empty_like(q)
    if T == 0:
        return out
    acc = ml = 0
    if p.partials is not None:
        n_acc = T * H * p.grid[2] * hd
        scratch = torch.empty(n_acc + T * H * p.grid[2] * 2,
                              dtype=torch.float32, device=q.device)
        acc = scratch.data_ptr()
        ml = acc + 4 * n_acc
    err = getattr(build.load(), fn)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), *(t.data_ptr() for t in index),
        out.data_ptr(), acc, ml, T, H, KV, hd, bs,
        block_tables.shape[1], window, 1.0 / (hd ** 0.5),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, fn)
    return out


def ragged_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           req_rows: torch.Tensor, q_lens: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """Shapes as in :func:`ragged_paged_attention_ref`.  On a CUDA tensor
    the kernel runs (rows with ``q_lens == 0`` come back as zeros); on a
    CPU tensor the plain version does."""
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(q, k_pool, v_pool, block_tables,
                                          req_rows, q_lens, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    p = _check(q, k_pool, v_pool, block_tables, req_rows=req_rows,
               q_lens=q_lens)
    out = _launch("ragged_paged_attention", p, q, k_pool, v_pool,
                  block_tables, req_rows, q_lens, window=window)
    if q.shape[0]:
        ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """Decode attention; shapes as in :func:`paged_attention_ref`, with
    ``lengths[b] <= nb * bs``.  On a CUDA tensor the kernel runs (rows
    with ``lengths == 0`` come back as zeros) and reads no block past a
    sequence's length; on a CPU tensor the plain version does."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, block_tables, lengths,
                                   window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    p = _check(q, k_pool, v_pool, block_tables, lengths=lengths)
    B = q.shape[0]
    if block_tables.shape[0] != B:
        raise ValueError(f"block_tables has {block_tables.shape[0]} rows "
                         f"for {B} sequences")
    out = _launch("paged_attention", p, q, k_pool, v_pool, block_tables,
                  lengths, window=window)
    if B:
        paged_attention.launches += 1
    return out


paged_attention.launches = 0
