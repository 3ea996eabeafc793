"""Attention functions — the counterparts of the reference's
``repro/models/attention.py``.

- ``ragged_paged_attention``: the mixed step's attention over the paged
  pool.  Every packed token (decode singletons and prefill-chunk rows
  alike) attends over its own request's blocks up to its causal length.
  The step writes the batch's K/V into the pool before this runs, so
  intra-chunk causality falls out of the ``q_lens`` mask.  The dispatch
  is by device only: a CUDA tensor goes to the hand-written kernel, a
  CPU tensor to its plain version (``repro_torch.kernels.paged_attention``).
- ``flash_attention`` / ``cross_attention``: full-sequence attention
  (whisper's bidirectional encoder, the sequential prefill chunk over
  its cached past and itself, decoder → encoder cross-attention), plain
  torch: the reference has no Pallas kernel for them.  Scores and
  softmax in float32, as the reference's.
- ``packed_cross_attention``: the mixed and sequential steps'
  cross-attention, each packed query row over its own request's encoder
  K/V, with ``packed_cross_attention_ref`` (the reference's per-token
  form) as its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import paged_attention as _kernel

NEG_INF = -1e30
# query rows per float32 softmax in ``flash_attention`` (bounds the score
# memory; every row's softmax is whole, so it changes no result)
Q_BLOCK = 512


def ragged_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           req_rows: torch.Tensor, q_lens: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """q: (T, H, hd); k_pool/v_pool: (NB, bs, KV, hd); block_tables:
    (R, nb) int32; req_rows, q_lens: (T,) int32.  Returns (T, H, hd)."""
    return _kernel.ragged_paged_attention(q, k_pool, v_pool, block_tables,
                                          req_rows, q_lens, window=window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0
                    ) -> torch.Tensor:
    """GQA attention over whole sequences (the reference's blocked
    online-softmax ``flash_attention``, here one float32 softmax per
    block of ``Q_BLOCK`` query rows).

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd).  ``q_offset``: absolute
    position of q[0] against k[0]; ``window`` > 0 masks keys more than
    ``window - 1`` positions back.  Returns (B, Sq, H, hd) in q's
    dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]      # (B, KV, 1, Sk, hd)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    kpos = torch.arange(Sk, device=q.device)
    outs = []
    for lo in range(0, Sq, Q_BLOCK):
        qb = q[:, lo:lo + Q_BLOCK].float()
        n = qb.shape[1]
        qr = qb.reshape(B, n, KV, G, hd).permute(0, 2, 3, 1, 4)
        s = (qr @ kf.transpose(-1, -2)) * scale         # (B, KV, G, n, Sk)
        if causal or window > 0:
            qpos = q_offset + lo + torch.arange(n, device=q.device)
            mask = torch.ones((n, Sk), dtype=torch.bool, device=q.device)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                mask &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        o = torch.softmax(s, dim=-1) @ vf               # (B, KV, G, n, hd)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, n, H, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """Full (non-causal, unmasked) attention, decoder → encoder.
    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd)."""
    return flash_attention(q, k, v, causal=False)


def packed_cross_attention_ref(q: torch.Tensor, xk: torch.Tensor,
                               xv: torch.Tensor) -> torch.Tensor:
    """Plain version (a port of ``repro/kernels/ref.py``'s
    ``packed_cross_attention_ref``): one query row per packed token, each
    over its own copy of its request's projected encoder K/V.

    q: (T, H, hd); xk/xv: (T, Se, KV, hd).  Returns (T, H, hd)."""
    T, H, hd = q.shape
    KV = xk.shape[2]
    scale = 1.0 / (hd ** 0.5)
    qr = q.reshape(T, KV, H // KV, hd).float()
    s = torch.einsum("tkgd,tskd->tkgs", qr, xk.float()) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("tkgs,tskd->tkgd", p, xv.float())
    return out.reshape(T, H, hd).to(q.dtype)


def packed_cross_attention(q: torch.Tensor, xk: torch.Tensor,
                           xv: torch.Tensor, rows: torch.Tensor,
                           cols: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Cross-attention of packed query rows over R requests' encoder K/V,
    with no per-token copy of them: the rows are scattered into an
    (R, n_cols) grid (token t at ``(rows[t], cols[t])``; two tokens share
    a cell only if their outputs are discarded), each request's rows
    attend over its own K/V in one batched product, and the outputs are
    gathered back.  Equal to :func:`packed_cross_attention_ref` on
    ``xk[rows]`` within float32 rounding.

    q: (T, H, hd); xk/xv: (R, KV, Se, hd), float32 or q's dtype (the
    products run in float32); rows, cols: (T,) int.  Returns (T, H, hd)."""
    T, H, hd = q.shape
    R, KV, Se, _ = xk.shape
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    rows, cols = rows.long(), cols.long()
    grid = torch.zeros((R, KV, G, n_cols, hd), dtype=torch.float32,
                       device=q.device)
    grid[rows, :, :, cols] = q.reshape(T, KV, G, hd).float()
    grid = grid.reshape(R, KV, G * n_cols, hd)
    s = (grid @ xk.float().transpose(-1, -2)) * scale   # (R, KV, G*C, Se)
    o = torch.softmax(s, dim=-1) @ xv.float()           # (R, KV, G*C, hd)
    o = o.reshape(R, KV, G, n_cols, hd)[rows, :, :, cols]
    return o.reshape(T, H, hd).to(q.dtype)
