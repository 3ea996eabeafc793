"""Activated-LoRA adapter weights (and the vanilla-LoRA baseline), the
counterpart of the reference's ``repro/core/alora.py``.

Adapter weights mirror the reference's segment stacking: for each
attention segment a dict {"aq","bq","ak","bk","av","bv"} with leading
(repeats, count) layer dims; for each SSM segment {"a","b"} on the fused
[z | xBC | dt] input projection (B spans its full width; the delta is
sliced onto the split ``in_z``/``in_xbc``/``in_dt`` products).
``stack_adapters`` inserts the zero adapter at index 0 and stacks along
a new slot axis; ``per_layer_adapters`` slices a stacked tree into the
per-layer list the runner consumes.

aLoRA and vanilla LoRA weights are the same objects; they differ in
where they apply (``activation_mask``) and how their blocks hash
(``block_hash``).  Paper ranks: LoRA r=8, aLoRA r=32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common import resolve_device, tree_leaves, tree_map
from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import (check_supported,  # noqa: F401
                                      per_layer_adapters, period_segments)
from repro_torch.models.ssm import in_proj_dim

Params = Dict[str, Any]

PAPER_LORA_RANK = 8
PAPER_ALORA_RANK = 32


@dataclass(frozen=True)
class AdapterSpec:
    """A registered adapter: ``invocation_tokens`` present ⇒ Activated
    LoRA (paper §3), absent ⇒ vanilla LoRA."""
    name: str
    rank: int
    invocation_tokens: Optional[Tuple[int, ...]] = None

    @property
    def kind(self) -> str:
        return "alora" if self.invocation_tokens is not None else "lora"


def leaf_shapes(cfg: ModelConfig, rank: int, kind: str = ATTN
                ) -> Dict[str, Tuple[int, ...]]:
    """Per-layer shapes of one adapter's A/B leaves (no slot axis) for a
    layer of ``kind``."""
    H, KV, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    if kind != ATTN:
        return {"a": (d, rank), "b": (rank, in_proj_dim(cfg))}
    return {"aq": (d, rank), "bq": (rank, H * hd),
            "ak": (d, rank), "bk": (rank, KV * hd),
            "av": (d, rank), "bv": (rank, KV * hd)}


def init_adapter_weights(generator: torch.Generator, cfg: ModelConfig,
                         rank: int, zero_b: bool = False, *,
                         device="cuda") -> Params:
    """One adapter's weights, segment-stacked like the model's params,
    with the reference's standard deviations (A: 1/sqrt(d); B:
    0.02/sqrt(rank), or zero)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg)
    repeats, segs = period_segments(cfg)
    a_std = 1.0 / math.sqrt(cfg.d_model)
    b_std = 0.0 if zero_b else 0.02 / math.sqrt(rank)
    out: Params = {}
    for si, (kind, count) in enumerate(segs):
        seg = {}
        for name, shape in leaf_shapes(cfg, rank, kind).items():
            std = a_std if name.startswith("a") else b_std
            full = (repeats, count) + shape
            if std == 0.0:
                seg[name] = torch.zeros(full, dtype=dtype, device=dev)
            else:
                seg[name] = (torch.randn(full, generator=generator,
                                         dtype=torch.float32, device=dev)
                             * std).to(dtype)
        out[f"seg{si}"] = seg
    return out


def zero_adapter_weights(cfg: ModelConfig, rank: int, *, device="cuda"
                         ) -> Params:
    """The index-0 'no adapter' entry (all zeros ⇒ the delta is exactly 0)."""
    check_supported(cfg)
    dev = resolve_device(device)
    repeats, segs = period_segments(cfg)
    return {f"seg{si}": {name: torch.zeros((repeats, count) + shape,
                                           dtype=dtype_of(cfg), device=dev)
                         for name, shape in leaf_shapes(cfg, rank,
                                                        kind).items()}
            for si, (kind, count) in enumerate(segs)}


def adapter_rank_of(weights: Params) -> int:
    """Read an adapter's rank off its first segment's A matrix."""
    seg = weights[sorted(weights)[0]]
    return (seg["aq"] if "aq" in seg else seg["a"]).shape[-1]


def pad_adapter_rank(weights: Params, target_rank: int) -> Params:
    """Zero-extend an adapter's rank dimension to ``target_rank``: zero
    columns appended to A (axis -1) and matching zero rows to B (axis
    -2).  ``x @ [A|0] @ [B;0]`` equals ``x @ A @ B`` up to summation
    order — the contraction over r runs over a different length, so the
    two agree within rounding (tested with a tolerance), not bitwise."""
    r = adapter_rank_of(weights)
    if r == target_rank:
        return weights
    if r > target_rank:
        raise ValueError(f"rank {r} exceeds the target rank {target_rank}")
    extra = target_rank - r

    def pad(key: str, leaf: torch.Tensor) -> torch.Tensor:
        if key.startswith("a"):                 # A: (..., d, r) — pad cols
            return F.pad(leaf, (0, extra))
        return F.pad(leaf, (0, 0, 0, extra))    # B: (..., r, out) — pad rows

    return {seg: {k: pad(k, v) for k, v in leaves.items()}
            for seg, leaves in weights.items()}


def stack_adapters(cfg: ModelConfig, adapters: List[Params], rank: int, *,
                   device=None) -> Params:
    """Stack [zero, ad_1, ..., ad_n] along a new slot axis (axis 2), each
    adapter zero-extended to ``rank`` first.  Output leaves:
    (repeats, count, n+1, ...).  ``device`` defaults to the adapters'."""
    if device is None:
        if not adapters:
            raise ValueError("stack_adapters needs a device when given "
                             "no adapters")
        device = tree_leaves(adapters[0])[0].device
    all_ads = [zero_adapter_weights(cfg, rank, device=device)] + \
        [pad_adapter_rank(w, rank) for w in adapters]
    return tree_map(lambda *xs: torch.stack(xs, dim=2), *all_ads)
