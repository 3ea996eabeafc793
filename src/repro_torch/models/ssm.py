"""Mamba2 (SSD) blocks, the PyTorch counterpart of the reference's
``repro/models/ssm.py``.  [arXiv:2405.21060]

``ssd_ragged_forward`` is one SSM sublayer over a mixed ragged batch:
every scheduled token (decode singletons and prefill chunks) packed
along one token axis, each request's tokens a contiguous segment that
continues from that request's live recurrent and conv state.  The
rounding points follow the reference: the input projections and the
adapter delta in the activation dtype; the causal conv, the scan inputs
(``xs``, ``B``, ``C``, ``dA``, ``dt``), the gated norm and the output
projection in float32, rounded once to the activation dtype.  The conv
is index gathers and a float32 einsum, as in the reference (no
``F.conv1d``, which runs float32 in TF32 on a card by default).

``ssd_forward`` (the chunked SSD over whole sequences: quadratic within
a chunk, a recurrence on the (nh, N, P) state across chunks, the state
at every chunk boundary on request) and ``ssd_decode_step`` (one token
of the recurrence) serve the sequential execution mode and the
full-sequence model (``models.model.forward_full`` / ``decode_step``).
From a zero state, with no boundary states asked for and no gradient
needed, ``ssd_forward``'s scan is the dense SSD kernel
(``kernels.ssd_chunk.ssd_chunk_scan``: on a card the hand-written one);
the sequential mode's prefill chunk (from the live state, keeping every
boundary state) and a pass under autograd run the chunked scan here.
Their adapter delta over every resident slot is the grouped delta with
all of them active, which is the reference's dense delta: on a card it
is the hand-written kernel's one-pair entry.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_chunk import (ragged_ssd_chunk_scan,
                                           ssd_chunk_scan)
from repro_torch.models.layers import dtype_of, lora_delta_dispatch

Params = Dict[str, Any]


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_inner, heads, conv channels) of an SSM layer."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.ngroups * s.state_dim
    return d_inner, nheads, conv_ch


def in_proj_dim(cfg: ModelConfig) -> int:
    """Width of the fused [z | xBC | dt] input projection (the SSM
    adapter's B output)."""
    d_inner, nheads, conv_ch = ssm_dims(cfg)
    return d_inner + conv_ch + nheads


def init_ssm(generator: torch.Generator, cfg: ModelConfig, dtype,
             device) -> Params:
    """One SSM layer's weights with the reference's shapes, dtypes and
    distributions (``init_ssm``): split input projections ``in_z`` /
    ``in_xbc`` / ``in_dt``, the depthwise conv, ``A_log`` = log(1..nh),
    ``dt_bias`` with softplus(dt_bias) log-uniform in [1e-3, 1e-1], ``D``
    = 1 (``A_log``, ``dt_bias`` and ``D`` in float32)."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nheads, conv_ch = ssm_dims(cfg)
    std = 0.02
    out_std = 0.02 / math.sqrt(2 * cfg.num_layers)

    def normal(shape, sd):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * sd).to(dtype)

    u = torch.rand((nheads,), generator=generator, dtype=torch.float32,
                   device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    return {
        "in_z": normal((d, d_inner), std),
        "in_xbc": normal((d, conv_ch), std),
        "in_dt": normal((d, nheads), std),
        "conv_w": normal((s.conv_width, conv_ch), std),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, nheads + 1, dtype=torch.float32,
                                        device=device)),
        "dt_bias": dt_bias,
        "D": torch.ones((nheads,), dtype=torch.float32, device=device),
        "norm_w": torch.ones((d_inner,), dtype=dtype, device=device),
        "out_proj": normal((d_inner, d), out_std),
    }


def init_ssm_state(cfg: ModelConfig, batch: int, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero (ssm state (batch, nh, N, P) float32, conv window (batch,
    W-1, ch) in the model dtype)."""
    s = cfg.ssm
    _, nh, conv_ch = ssm_dims(cfg)
    return (torch.zeros((batch, nh, s.state_dim, s.head_dim),
                        dtype=torch.float32, device=device),
            torch.zeros((batch, s.conv_width - 1, conv_ch),
                        dtype=dtype_of(cfg), device=device))


def _all_slots_delta(x: torch.Tensor, alora: Params,
                     adapter_idx: torch.Tensor) -> torch.Tensor:
    """The fused input projection's delta of every slot of the stack
    (slot 0 is the zero adapter): the grouped delta with all of them
    active."""
    slots = torch.arange(1, alora["a"].shape[0], dtype=torch.int32,
                         device=x.device)
    return lora_delta_dispatch(x, alora["a"], alora["b"], adapter_idx,
                               slots)


def _causal_conv(xBC: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor, conv_state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along the sequence.  xBC: (B, S, C); conv_w:
    (W, C); conv_state: (B, W-1, C) raw inputs before xBC (None: zeros).
    Returns (the activated output in xBC's dtype, the new window)."""
    B, S, C = xBC.shape
    W = conv_w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((B, W - 1, C), dtype=xBC.dtype,
                                 device=xBC.device)
    full = torch.cat([conv_state, xBC], dim=1)             # (B, W-1+S, C)
    out = torch.zeros((B, S, C), dtype=torch.float32, device=xBC.device)
    for w in range(W):
        out = out + full[:, w:w + S].float() * conv_w[w].float()
    out = F.silu(out + conv_b.float()).to(xBC.dtype)
    return out, full[:, -(W - 1):]


def chunked_scan(xs: torch.Tensor, Bh: torch.Tensor, Ch: torch.Tensor,
                 dA: torch.Tensor, dt: torch.Tensor, Q: int,
                 ssm_state: Optional[torch.Tensor] = None):
    """The chunked SSD scan in plain torch (the reference's jnp
    ``chunk_step``): quadratic within chunks of ``Q`` tokens, whose
    products run as one batch, and a recurrence on the state across
    them.  xs (B, S, nh, P), Bh/Ch (B, S, nh, N), dA/dt (B, S, nh), all
    float32; ``ssm_state`` (B, nh, N, P) the entry state (None: zeros).
    Returns (y (B, S, nh, P) without the D skip, the final state, the
    state after each chunk (nc, B, nh, N, P))."""
    B, S, nh, P = xs.shape
    N = Bh.shape[-1]
    pad = (-S) % Q
    nc = (S + pad) // Q

    def chunked(t):
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape((B, nc, Q) + t.shape[2:])

    xc, Bc, Cc, dAc, dtc = map(chunked, (xs, Bh, Ch, dA, dt))
    csum = torch.cumsum(dAc, dim=2)                        # (B, nc, Q, nh)
    total = csum[:, :, -1]                                 # (B, nc, nh)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xs.device).tril()
    diff = csum[:, :, :, None, :] - csum[:, :, None, :, :]
    Lm = torch.where(tri[:, :, None], torch.exp(diff),
                     torch.zeros_like(diff))               # (B, nc, Q, Q, nh)
    CB = torch.einsum("bcqhn,bckhn->bcqkh", Cc, Bc)
    Wm = CB * Lm * dtc[:, :, None, :, :]
    y = torch.einsum("bcqkh,bckhp->bcqhp", Wm, xc)
    decay_to_end = torch.exp(total[:, :, None, :] - csum)
    chunk_state = torch.einsum("bckhn,bckhp->bchnp",
                               Bc * (dtc * decay_to_end)[..., None], xc)
    state = ssm_state if ssm_state is not None else torch.zeros(
        (B, nh, N, P), dtype=torch.float32, device=xs.device)
    entry, after = [], []
    for c in range(nc):
        entry.append(state)
        state = torch.exp(total[:, c])[..., None, None] * state \
            + chunk_state[:, c]
        after.append(state)
    # the incoming state's contribution to every chunk
    y = y + torch.einsum("bcqhn,bchnp->bcqhp", Cc * torch.exp(csum)[..., None],
                         torch.stack(entry, dim=1))
    return y.reshape(B, nc * Q, nh, P)[:, :S], state, torch.stack(after)


def ssd_forward(p: Params, cfg: ModelConfig, x: torch.Tensor,
                ssm_state: Optional[torch.Tensor] = None,
                conv_state: Optional[torch.Tensor] = None,
                alora: Optional[Params] = None,
                adapter_idx: Optional[torch.Tensor] = None,
                valid_len: Optional[int] = None,
                return_boundary_states: bool = False, tp=None):
    """Chunked SSD over whole sequences (chunks of ``cfg.ssm.chunk_size``
    tokens).  x: (B, S, d).  Returns (y (B, S, d), ssm_state (B, nh, N,
    P) float32, conv_state (B, W-1, ch)).

    ``valid_len``: tokens at and after this index are padding (dt forced
    to 0, so the state stays frozen; the returned conv window ends at
    ``valid_len``).  ``return_boundary_states``: also return the state
    and the raw conv window at every chunk boundary, ((nc, B, nh, N, P),
    (nc, B, W-1, ch)) — what the engine snapshots when the chunk size is
    its block size.

    The scan's route is decided by the arguments alone: from a zero
    state (``ssm_state is None``), with no boundary states and no
    gradient needed (:func:`dense_scan_applies`), it is the dense SSD
    scan ``ssd_chunk_scan`` (the kernel on a CUDA tensor, its plain
    version on the CPU); otherwise :func:`chunked_scan`, which autograd
    differentiates.

    ``tp``: a rank's share of a sharded step
    (``distributed.parallel.TensorParallel``): ``p`` and the adapter
    hold the rank's heads (the widths are read off ``p``), the gated
    norm's sum of squares and out_proj's product are summed over
    ``model``."""
    s = cfg.ssm
    B, S, _ = x.shape
    N, P = s.state_dim, s.head_dim
    nh, d_inner, conv_ch, G = _widths(p, N)
    hpg = nh // G
    W = s.conv_width
    Q = min(s.chunk_size, S)

    z = x @ p["in_z"]
    xBC = x @ p["in_xbc"]
    dt = x @ p["in_dt"]                                    # (B, S, nh)
    if alora is not None:
        if adapter_idx is None:
            raise ValueError("alora weights given without adapter_idx")
        delta = _all_slots_delta(x, alora, adapter_idx)
        z = z + delta[..., :d_inner]
        xBC = xBC + delta[..., d_inner:d_inner + conv_ch]
        dt = dt + delta[..., d_inner + conv_ch:d_inner + conv_ch + nh]
    seq_valid = None
    if valid_len is not None:
        seq_valid = torch.arange(S, device=x.device) < valid_len
        xBC = xBC * seq_valid[None, :, None].to(xBC.dtype)
    if conv_state is None:
        conv_state = torch.zeros((B, W - 1, conv_ch), dtype=xBC.dtype,
                                 device=x.device)
    full_raw = torch.cat([conv_state, xBC], dim=1)         # (B, W-1+S, ch)
    xBC, new_conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                       conv_state)
    if valid_len is not None:
        new_conv_state = full_raw[:, valid_len:valid_len + W - 1]
    xs = xBC[..., :d_inner].reshape(B, S, nh, P).float()
    Bh = xBC[..., d_inner:d_inner + G * N].reshape(B, S, G, N) \
        .repeat_interleave(hpg, dim=2).float()             # (B, S, nh, N)
    Ch = xBC[..., d_inner + G * N:].reshape(B, S, G, N) \
        .repeat_interleave(hpg, dim=2).float()
    dt = F.softplus(dt.float() + p["dt_bias"])
    if seq_valid is not None:
        dt = dt * seq_valid[None, :, None]
    dA = dt * (-torch.exp(p["A_log"]))                     # (B, S, nh)

    if dense_scan_applies(p, x, ssm_state, return_boundary_states):
        y, state = ssd_chunk_scan(xs.contiguous(), Bh.contiguous(),
                                  Ch.contiguous(), dA.contiguous(),
                                  dt.contiguous())
    else:
        y, state, after = chunked_scan(xs, Bh, Ch, dA, dt, Q, ssm_state)
    y = y + p["D"][:, None] * xs
    y = _rmsnorm_gated(y.reshape(B, S, d_inner), z, p["norm_w"],
                       cfg.norm_eps, tp)
    out = _out_proj(y, p, tp).to(x.dtype)
    if not return_boundary_states:
        return out, state, new_conv_state
    # the raw conv window ending at each chunk boundary (clamped to S)
    nc = after.shape[0]
    ends = ((torch.arange(nc, device=x.device) + 1) * Q).clamp(max=S)
    idx = ends[:, None] + torch.arange(W - 1, device=x.device)[None, :]
    boundary_conv = full_raw[:, idx].transpose(0, 1)       # (nc, B, W-1, ch)
    return out, state, new_conv_state, (after, boundary_conv)


def _widths(p: Params, N: int) -> Tuple[int, int, int, int]:
    """(heads, d_inner, conv channels, groups) of the SSM weights ``p``:
    the model's, or a rank's head-aligned slice of them."""
    nh, d_inner, ch = (p["A_log"].shape[0], p["norm_w"].shape[0],
                       p["conv_w"].shape[1])
    return nh, d_inner, ch, (ch - d_inner) // (2 * N)


def _out_proj(y: torch.Tensor, p: Params, tp) -> torch.Tensor:
    """The float32 output projection, summed over ``model`` on a rank
    holding a slice of the heads."""
    out = y @ p["out_proj"].float()
    return out if tp is None else tp.reduce(out, "ssm")


def dense_scan_applies(p: Params, x: torch.Tensor,
                       ssm_state: Optional[torch.Tensor],
                       return_boundary_states: bool) -> bool:
    """Whether :func:`ssd_forward`'s scan is the dense SSD scan: from a
    zero state, no boundary states, and no gradient to carry (the dense
    kernel has no backward; training differentiates the chunked scan, as
    the reference's training differentiates its jnp scan)."""
    if ssm_state is not None or return_boundary_states:
        return False
    return not (torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in p.values())))


def ssd_decode_step(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    ssm_state: torch.Tensor, conv_state: torch.Tensor,
                    alora: Optional[Params] = None,
                    adapter_idx: Optional[torch.Tensor] = None, tp=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token of the recurrence.  x: (B, 1, d); ssm_state (B, nh, N,
    P) float32; conv_state (B, W-1, ch).  Returns (y (B, 1, d), the new
    ssm state, the new conv window).  ``tp``: as in
    :func:`ssd_forward` (the states hold the rank's heads)."""
    s = cfg.ssm
    Bsz = x.shape[0]
    N, P = s.state_dim, s.head_dim
    nh, d_inner, conv_ch, G = _widths(p, N)
    hpg = nh // G
    x0 = x[:, 0]
    z = x0 @ p["in_z"]
    xBC = x0 @ p["in_xbc"]
    dt = x0 @ p["in_dt"]
    if alora is not None:
        if adapter_idx is None:
            raise ValueError("alora weights given without adapter_idx")
        idx = adapter_idx[:, 0] if adapter_idx.dim() == 2 else adapter_idx
        delta = _all_slots_delta(x0, alora, idx)
        z = z + delta[:, :d_inner]
        xBC = xBC + delta[:, d_inner:d_inner + conv_ch]
        dt = dt + delta[:, d_inner + conv_ch:d_inner + conv_ch + nh]
    full = torch.cat([conv_state, xBC[:, None, :]], dim=1)  # (B, W, ch)
    conv_out = F.silu(torch.einsum("bwc,wc->bc", full.float(),
                                   p["conv_w"].float()) + p["conv_b"].float())
    xt = conv_out[:, :d_inner].reshape(Bsz, nh, P)
    Bt = conv_out[:, d_inner:d_inner + G * N].reshape(Bsz, G, N) \
        .repeat_interleave(hpg, dim=1)                     # (B, nh, N)
    Ct = conv_out[:, d_inner + G * N:].reshape(Bsz, G, N) \
        .repeat_interleave(hpg, dim=1)
    dt = F.softplus(dt.float() + p["dt_bias"])            # (B, nh)
    dA = torch.exp(dt * (-torch.exp(p["A_log"])))
    new_state = dA[..., None, None] * ssm_state \
        + torch.einsum("bhn,bhp->bhnp", Bt * dt[..., None], xt)
    y = torch.einsum("bhn,bhnp->bhp", Ct, new_state) + p["D"][:, None] * xt
    y = _rmsnorm_gated(y.reshape(Bsz, d_inner), z, p["norm_w"], cfg.norm_eps,
                       tp)
    out = _out_proj(y, p, tp).to(x.dtype)
    return out[:, None, :], new_state, full[:, 1:]


def _rmsnorm_gated(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                   eps: float, tp=None) -> torch.Tensor:
    """The gated RMSNorm over d_inner; on a rank holding a slice of the
    heads (``tp``), the mean of squares is over every rank's channels."""
    y = y * F.silu(z.float())
    if tp is None or not tp.layout.ssm:
        var = y.square().mean(dim=-1, keepdim=True)
    else:
        var = tp.norm_sum(y.square().sum(dim=-1, keepdim=True)) \
            / tp.layout.d_inner
    return y * torch.rsqrt(var + eps) * w.float()


def _windows(xBC: torch.Tensor, live_conv: torch.Tensor,
             end_rows: torch.Tensor, end_cols: torch.Tensor,
             slots: torch.Tensor, length: int, dtype) -> torch.Tensor:
    """Raw conv-input windows of ``length`` columns, each ending at (and
    including) packed row ``end_rows[i]``, whose offset in its segment is
    ``end_cols[i]``.  A column before the segment start comes from run
    slot ``slots[i]``'s live conv window (its last W-1 raw inputs, oldest
    first).  Returns (n, length, ch) in ``dtype``."""
    W1 = live_conv.shape[1]                                       # W - 1
    T, ch = xBC.shape
    n = end_rows.shape[0]
    j = torch.arange(length, device=xBC.device)
    back = length - 1 - j                     # columns before the end row
    rel = end_cols[:, None] - back[None, :]           # offset in segment
    from_pack = xBC[(end_rows[:, None] - back[None, :]).clamp(0, T - 1)]
    sidx = (rel + W1).clamp(0, W1 - 1)
    from_state = torch.gather(live_conv[slots], 1,
                              sidx[:, :, None].expand(n, length, ch))
    return torch.where((rel >= 0)[..., None], from_pack.to(dtype),
                       from_state.to(dtype))


def ssd_ragged_forward(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                       live_ssm: torch.Tensor, live_conv: torch.Tensor,
                       tok_slots: torch.Tensor, row_cols: torch.Tensor,
                       snap_rows: torch.Tensor, last_rows: torch.Tensor,
                       row_slots: torch.Tensor,
                       snap_ssm_out: torch.Tensor, snap_conv_out: torch.Tensor,
                       alora: Optional[Params] = None,
                       adapter_idx: Optional[torch.Tensor] = None,
                       active_slots: Optional[torch.Tensor] = None,
                       tp=None) -> torch.Tensor:
    """One SSM sublayer over a mixed ragged batch.

    x:         (T, d) packed hidden rows (a rank's own rows under token
               sharding; every per-token argument below spans all rows)
    live_ssm:  (MR, nh, N, P) float32 — per-run-slot recurrent state
    live_conv: (MR, W-1, ch)          — per-run-slot raw conv window
    tok_slots: (T,) int32 — token → its request's run slot
    row_cols:  (T,) int32 — token's offset in its segment (0 = start)
    snap_rows: (Cb,) int32 — packed indices of block-boundary tokens
    last_rows: (R,) int32 — packed index of each request's final token
    row_slots: (R,) int32 — run slot per request row (scatter-back)
    snap_ssm_out:  (Cb, nh, N, P) float32 — written with the post-token
                   states at ``snap_rows``
    snap_conv_out: (Cb, W-1, ch) in the pool's dtype — written with the
                   raw conv windows ending at ``snap_rows``
    alora/adapter_idx/active_slots: the fused input-projection adapter
               delta (``layers.lora_delta_dispatch``; ``adapter_idx`` of
               x's rows)
    tp:        a rank's share of a sharded step
               (``distributed.parallel.TensorParallel``): ``p``, the pools
               and the adapter hold the rank's heads (the widths are read
               off ``p``); xBC and dt rows are gathered over the data
               axis before the conv and the scan, the gated norm and
               out_proj reduce over the model axis

    Updates ``live_ssm`` and ``live_conv`` IN PLACE at ``row_slots`` (the
    reference returns the updated pools instead; every read of the old
    rows is enqueued before the writes).  Padded request rows must all
    target one dump slot, the only place duplicate writes may land.
    Returns y (T, d) in x's dtype."""
    s = cfg.ssm
    N, P = s.state_dim, s.head_dim
    # the (rank's) widths: its heads, their x channels, their groups
    nh, d_inner, conv_ch, G = _widths(p, N)
    hpg = nh // G
    W = s.conv_width
    dev = x.device

    z = x @ p["in_z"]
    xBC = x @ p["in_xbc"]
    dtr = x @ p["in_dt"]                                    # (T, nh)
    if alora is not None:
        if adapter_idx is None or active_slots is None:
            raise ValueError("alora weights given without adapter_idx "
                             "and active_slots")
        delta = lora_delta_dispatch(x, alora["a"], alora["b"], adapter_idx,
                                    active_slots)
        z = z + delta[:, :d_inner]
        xBC = xBC + delta[:, d_inner:d_inner + conv_ch]
        # (a card's slot stack may pad B's width with zero columns)
        dtr = dtr + delta[:, d_inner + conv_ch:d_inner + conv_ch + nh]
    own = slice(None)
    if tp is not None:
        own = tp.rows(row_cols.shape[0])
        xBC, dtr = tp.gather_rows(xBC), tp.gather_rows(dtr)
    T = xBC.shape[0]

    # ---- ragged causal conv -------------------------------------------
    cols, slots = row_cols.long(), tok_slots.long()
    last, snap = last_rows.long(), snap_rows.long()
    win = _windows(xBC, live_conv, torch.arange(T, device=dev), cols, slots,
                   W, xBC.dtype)                                  # (T, W, ch)
    conv_out = torch.einsum("twc,wc->tc", win.float(),
                            p["conv_w"].float()) + p["conv_b"].float()
    conv_out = F.silu(conv_out)
    # the new live conv window per request ends at its last token; the
    # snapshot windows end AT each boundary token
    new_rows = _windows(xBC, live_conv, last, cols[last], row_slots.long(),
                        W - 1, live_conv.dtype)
    snap_conv_out.copy_(_windows(xBC, live_conv, snap, cols[snap],
                                 slots[snap], W - 1, live_conv.dtype))

    # ---- ragged SSD scan ----------------------------------------------
    xs = conv_out[:, :d_inner].reshape(T, nh, P).contiguous()
    Bm = conv_out[:, d_inner:d_inner + G * N].reshape(T, G, N)
    Cm = conv_out[:, d_inner + G * N:].reshape(T, G, N)
    Bh = Bm.repeat_interleave(hpg, dim=1).contiguous()            # (T, nh, N)
    Ch = Cm.repeat_interleave(hpg, dim=1).contiguous()
    dtv = F.softplus(dtr.float() + p["dt_bias"])
    dA = dtv * (-torch.exp(p["A_log"]))                           # (T, nh)
    seg_starts = (row_cols == 0).to(torch.int32)
    # the kept states: each request's last token, then the boundaries
    R = last_rows.shape[0]
    y, kept = ragged_ssd_chunk_scan(xs, Bh, Ch, dA.contiguous(),
                                    dtv.contiguous(), seg_starts, tok_slots,
                                    live_ssm, torch.cat([last_rows,
                                                         snap_rows]))
    snap_ssm_out.copy_(kept[R:])

    # scatter back: every read of the old live rows is enqueued above
    live_ssm.index_copy_(0, row_slots.long(), kept[:R])
    live_conv.index_copy_(0, row_slots.long(), new_rows)

    y = y[own].float() + p["D"][:, None] * xs[own]
    y = _rmsnorm_gated(y.reshape(-1, d_inner), z, p["norm_w"], cfg.norm_eps,
                       tp)
    return _out_proj(y, p, tp).to(x.dtype)
