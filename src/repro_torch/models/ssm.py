"""Mamba2 (SSD) blocks of the mixed serving step, the PyTorch counterpart
of the reference's ``repro/models/ssm.py``.  [arXiv:2405.21060]

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

The reference's full-sequence ``ssd_forward`` and single-token
``ssd_decode_step`` serve its sequential oracle path and are ported
with it (ROADMAP A11).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_chunk import ragged_ssd_chunk_scan
from repro_torch.models.layers import lora_delta_dispatch

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


def _rmsnorm_gated(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                   eps: float) -> torch.Tensor:
    y = y * F.silu(z.float())
    var = y.square().mean(dim=-1, keepdim=True)
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
                       active_slots: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """One SSM sublayer over a mixed ragged batch.

    x:         (T, d) packed hidden rows
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
               delta (``layers.lora_delta_dispatch``)

    Updates ``live_ssm`` and ``live_conv`` IN PLACE at ``row_slots`` (the
    reference returns the updated pools instead; every read of the old
    rows is enqueued before the writes).  Padded request rows must all
    target one dump slot, the only place duplicate writes may land.
    Returns y (T, d) in x's dtype."""
    s = cfg.ssm
    T = x.shape[0]
    d_inner, nh, conv_ch = ssm_dims(cfg)
    G, N, P = s.ngroups, s.state_dim, s.head_dim
    hpg = nh // G
    W = s.conv_width
    dev = x.device

    z = x @ p["in_z"]
    xBC = x @ p["in_xbc"]
    dtr = x @ p["in_dt"]                                    # (T, nh)
    if alora is not None:
        if adapter_idx is None:
            raise ValueError("alora weights given without adapter_idx")
        delta = lora_delta_dispatch(x, alora["a"], alora["b"], adapter_idx,
                                    active_slots)
        z = z + delta[:, :d_inner]
        xBC = xBC + delta[:, d_inner:d_inner + conv_ch]
        dtr = dtr + delta[:, d_inner + conv_ch:]

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

    y = y.float() + p["D"][:, None] * xs
    y = _rmsnorm_gated(y.reshape(T, d_inner), z, p["norm_w"], cfg.norm_eps)
    return (y @ p["out_proj"].float()).to(x.dtype)
