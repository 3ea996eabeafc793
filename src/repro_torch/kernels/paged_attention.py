"""Ragged paged attention: the hand-written Hopper kernel that replaces
the reference's TPU kernel
``repro/kernels/paged_attention.py::ragged_paged_attention``, with its
plain PyTorch version beside it.

One query row per packed token (decode singletons and prefill-chunk
rows in the same launch); each attends over its own request's paged
K/V through ``block_tables[req_rows[t]]``, causal to ``q_lens[t]``,
with an optional sliding window and an fp32 online softmax.  The CUDA
source is ``repro_torch/csrc/paged_attention.cu``.

``ragged_paged_attention`` sends a CUDA tensor to the kernel and a CPU
tensor to :func:`ragged_paged_attention_ref`; nothing else selects
between them.  ``ragged_paged_attention.launches`` counts kernel
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
_SMEM_LIMIT = 48 * 1024


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


def _check(q, k_pool, v_pool, block_tables, req_rows, q_lens):
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("req_rows", req_rows),
                    ("q_lens", q_lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        "bfloat16")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("q, k_pool and v_pool must share one dtype")
    for name, t in (("block_tables", block_tables), ("req_rows", req_rows),
                    ("q_lens", q_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("req_rows", req_rows),
                    ("q_lens", q_lens)):
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
    if req_rows.shape != (T,) or q_lens.shape != (T,):
        raise ValueError("req_rows and q_lens must be (T,)")
    G = H // KV
    smem = 4 * (2 * G * hd + 2 * bs * hd + G * bs + 3 * G)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"tile needs {smem} B of shared memory, above the "
                         f"kernel's {_SMEM_LIMIT} B")


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
    _check(q, k_pool, v_pool, block_tables, req_rows, q_lens)
    T, H, hd = q.shape
    _, bs, KV, _ = k_pool.shape
    out = torch.empty_like(q)
    if T == 0:
        return out
    lib = build.load()
    err = lib.ragged_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), req_rows.data_ptr(), q_lens.data_ptr(),
        out.data_ptr(), T, H, KV, hd, bs, block_tables.shape[1], window,
        1.0 / (hd ** 0.5), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "ragged_paged_attention")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
