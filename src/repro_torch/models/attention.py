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
- ``flash_attention_remat``: ``flash_attention`` with a memory-efficient
  backward (an ``autograd.Function``; the reference's is a
  ``jax.custom_vjp`` over jnp, not a Pallas kernel): the forward saves
  (q, k, v, out, lse) and the backward recomputes the probabilities one
  (q block, kv block) tile at a time, in float32.
- ``decode_attention``, ``quantize_kv``/``dequantize_kv`` and
  ``write_kv_cache``: the dense decode caches of ``models.model``'s
  ``decode_step`` (a ring buffer of W slots under a window; int8 values
  with per-(token, head) scales under ``Runtime.kv_cache_quant``).
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


# ---------------------------------------------------------------------------
# full-sequence attention with a recomputing backward (training)
# ---------------------------------------------------------------------------
def _blocks(q, k, q_block: int, kv_block: int):
    """(query block, key block) lengths and counts over q (B, Sq, ...) and
    k (B, Sk, ...), as the reference pads them."""
    Sq, Sk = q.shape[1], k.shape[1]
    qb, kb = min(q_block, Sq), min(kv_block, Sk)
    return qb, kb, -(-Sq // qb), -(-Sk // kb)


def _tile_mask(lo: int, n: int, klo: int, m: int, *, causal: bool,
               window: int, q_offset: int, device) -> torch.Tensor:
    """(n, m) validity of query rows lo.. against key columns klo.."""
    qpos = q_offset + lo + torch.arange(n, device=device)
    kpos = klo + torch.arange(m, device=device)
    mask = torch.ones((n, m), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def _heads(t: torch.Tensor, KV: int) -> torch.Tensor:
    """(B, n, H, hd) float32 -> (B, KV, G, n, hd)."""
    B, n, H, hd = t.shape
    return t.float().reshape(B, n, KV, H // KV, hd).permute(0, 2, 3, 1, 4)


def _flash_fwd_lse(q, k, v, *, causal, window, q_offset, q_block,
                   kv_block):
    """Blocked online-softmax attention that also returns each query
    row's log-sum-exp (B, Sq, KV, G) float32: the residual the
    recomputing backward needs.  Output in q's dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    qb, kb, nq, nk = _blocks(q, k, q_block, kv_block)
    outs, lses = [], []
    for iq in range(nq):
        lo = iq * qb
        qi = _heads(q[:, lo:lo + qb], KV)                 # (B, KV, G, n, hd)
        n = qi.shape[3]
        m = torch.full((B, KV, G, n), NEG_INF, device=q.device)
        l = torch.zeros((B, KV, G, n), device=q.device)
        acc = torch.zeros((B, KV, G, n, hd), device=q.device)
        for ik in range(nk):
            klo = ik * kb
            kj = k[:, klo:klo + kb].float().permute(0, 2, 1, 3)[:, :, None]
            vj = v[:, klo:klo + kb].float().permute(0, 2, 1, 3)[:, :, None]
            s = (qi @ kj.transpose(-1, -2)) * scale      # (B, KV, G, n, m)
            mask = _tile_mask(lo, n, klo, kj.shape[3], causal=causal,
                              window=window, q_offset=q_offset,
                              device=q.device)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ vj
            m = m_new
        lsafe = torch.where(l == 0.0, torch.ones_like(l), l)
        outs.append((acc / lsafe[..., None]).permute(0, 3, 1, 2, 4)
                    .reshape(B, n, H, hd))
        lses.append((m + torch.log(lsafe)).permute(0, 3, 1, 2))
    return torch.cat(outs, 1).to(q.dtype), torch.cat(lses, 1)


class _FlashRemat(torch.autograd.Function):
    """The forward keeps (q, k, v, out, lse); the backward recomputes each
    (q block, kv block) tile's probabilities from them (the reference's
    ``_remat_bwd``), so no (Sq, Sk) matrix is ever held."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, q_block, kv_block):
        out, lse = _flash_fwd_lse(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, q_block=q_block,
                                  kv_block=kv_block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, q_offset, q_block, kv_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset, q_block, kv_block = ctx.opts
        B, Sq, H, hd = q.shape
        KV = k.shape[2]
        G = H // KV
        scale = 1.0 / (hd ** 0.5)
        qb, kb, nq, nk = _blocks(q, k, q_block, kv_block)
        do = _heads(dout, KV)                             # (B, KV, G, Sq, hd)
        D = (do * _heads(out, KV)).sum(-1)                # (B, KV, G, Sq)
        lse_h = lse.permute(0, 2, 3, 1)                   # (B, KV, G, Sq)
        dq = torch.zeros((B, KV, G, Sq, hd), device=q.device)
        dk = torch.zeros((B, KV, k.shape[1], hd), device=q.device)
        dv = torch.zeros_like(dk)
        for iq in range(nq):
            lo = iq * qb
            qi = _heads(q[:, lo:lo + qb], KV)
            n = qi.shape[3]
            doi, Di = do[..., lo:lo + n, :], D[..., lo:lo + n]
            for ik in range(nk):
                klo = ik * kb
                kj = k[:, klo:klo + kb].float().permute(0, 2, 1, 3)
                vj = v[:, klo:klo + kb].float().permute(0, 2, 1, 3)
                s = (qi @ kj[:, :, None].transpose(-1, -2)) * scale
                mask = _tile_mask(lo, n, klo, kj.shape[2], causal=causal,
                                  window=window, q_offset=q_offset,
                                  device=q.device)
                s = torch.where(mask, s, torch.full_like(s, NEG_INF))
                p = torch.exp(s - lse_h[..., lo:lo + n, None])
                dp = doi @ vj[:, :, None].transpose(-1, -2)
                ds = p * (dp - Di[..., None])             # (B, KV, G, n, m)
                dq[..., lo:lo + n, :] += (ds @ kj[:, :, None]) * scale
                dk[:, :, klo:klo + kb] += torch.einsum(
                    "bkgqs,bkgqd->bksd", ds, qi) * scale
                dv[:, :, klo:klo + kb] += torch.einsum(
                    "bkgqs,bkgqd->bksd", p, doi)
        dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
        return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
                dv.permute(0, 2, 1, 3).to(v.dtype),
                None, None, None, None, None)


def flash_attention_remat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0,
                          q_offset: int = 0, q_block: int = 512,
                          kv_block: int = 512) -> torch.Tensor:
    """:func:`flash_attention` (blocked by ``q_block`` x ``kv_block``)
    whose backward recomputes the attention probabilities tile by tile
    instead of keeping every tile's softmax: O(S) memory for the backward
    rather than O(S^2).  Shapes as in :func:`flash_attention`."""
    return _FlashRemat.apply(q, k, v, causal, window, q_offset, q_block,
                             kv_block)


# ---------------------------------------------------------------------------
# dense decode caches
# ---------------------------------------------------------------------------
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *, window: int = 0
                     ) -> torch.Tensor:
    """One decode step against a dense cache.  q: (B, 1, H, hd);
    k_cache/v_cache: (B, S_max, KV, hd).  ``cache_len`` (an int or a (B,)
    or 0-dim tensor) counts the valid tokens including the one written
    this step; under a window the cache is a ring buffer of min(W, S_max)
    slots, every slot below min(cache_len, W) valid.  Scores, softmax and
    the value product in float32; returns (B, 1, H, hd) in q's dtype."""
    B, Smax, KV, hd = k_cache.shape
    H = q.shape[2]
    scale = 1.0 / (hd ** 0.5)
    cap = Smax if window == 0 else min(window, Smax)
    n = torch.as_tensor(cache_len, device=q.device).reshape(-1)
    valid = torch.arange(Smax, device=q.device)[None, :] \
        < torch.clamp(n, max=cap)[:, None]                # (B or 1, Smax)
    qr = q.reshape(B, KV, H // KV, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", qr, k_cache.float()) * scale
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def quantize_kv(x: torch.Tensor):
    """Per-(token, head) symmetric int8.  x: (..., KV, hd) -> (int8
    values, float32 scales (..., KV)).  ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    xf = x.float()
    amax = xf.abs().amax(-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype
                  ) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def write_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor, pos, *,
                   window: int = 0):
    """Write one step's K/V (B, 1, ...) at position ``pos`` (an int or a
    tensor of one position or B), slot ``pos % W`` under a window.  The
    caches are written IN PLACE and returned (the reference returns
    updated copies; its callers donate the old ones)."""
    B, Smax = k_cache.shape[:2]
    cap = Smax if window == 0 else min(window, Smax)
    slot = (torch.as_tensor(pos, device=k_cache.device).reshape(-1)
            % cap).long().expand(B)
    rows = torch.arange(B, device=k_cache.device)
    k_cache.index_put_((rows, slot), k_new[:, 0])
    v_cache.index_put_((rows, slot), v_new[:, 0])
    return k_cache, v_cache
