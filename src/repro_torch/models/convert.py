"""The weight bridge: reference (JAX) parameter trees → the port, and
state both ways.

``jax.random`` streams cannot be reproduced in torch, so tests give both
packages the same weights by converting the reference's tree; decode
caches cross the same way (``caches_to_jax`` goes back, for
comparisons), and ``training.optimizer.adamw_state_from_jax`` carries
the optimizer's moments over with :func:`params_from_jax`.  The caller
hands over numpy leaves (``jax.tree.map(np.asarray, tree)``);
this module imports neither jax nor the reference package.  bfloat16
leaves (numpy's ``ml_dtypes`` bfloat16) go through an exact float32
round trip.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.common import resolve_device, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import check_supported, period_segments

Params = Dict[str, Any]


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(np_tree: Params, cfg: ModelConfig, device="cuda"
                    ) -> Params:
    """Unroll the reference's ``blocks/seg{i}`` leaves of shape
    (repeats, count, ...) into the port's per-layer list, in the order
    the reference's ``iter_layers`` walks them; every layout is kept
    (``embed/tok`` with the padded vocab, ``ln1``/``ln2``/``final_norm``,
    the untied ``embed/unembed`` where present, each decoder layer's
    ``xln``/``xattn``).  An encoder-decoder's ``encoder/blocks`` leaves,
    (num_encoder_layers, 1, ...), become ``encoder/layers``."""
    check_supported(cfg)
    dev = resolve_device(device)
    repeats, segs = period_segments(cfg)
    layers = []
    for r in range(repeats):
        for si, (_, count) in enumerate(segs):
            seg = np_tree["blocks"][f"seg{si}"]
            for c in range(count):
                layers.append(tree_map(lambda a: _tensor(a[r, c], dev), seg))
    params = {"embed": tree_map(lambda a: _tensor(a, dev), np_tree["embed"]),
              "final_norm": _tensor(np_tree["final_norm"], dev),
              "layers": layers}
    if cfg.is_encoder_decoder:
        enc = np_tree["encoder"]
        params["encoder"] = {
            "layers": [tree_map(lambda a: _tensor(a[i, 0], dev),
                                enc["blocks"])
                       for i in range(cfg.num_encoder_layers)],
            "final_norm": _tensor(enc["final_norm"], dev)}
    return params


def adapters_from_jax(np_tree: Params, cfg: ModelConfig, device="cuda"
                      ) -> Params:
    """Convert an ``init_adapter_weights`` or ``stack_adapters`` tree.
    The port keeps the reference's segment-stacked adapter layout
    (leaves (repeats, count[, slots], ...)), so ``AdapterPool.register``
    and ``per_layer_adapters`` take the same trees in both packages."""
    check_supported(cfg)
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), np_tree)


def _unroll(np_tree: Params, cfg: ModelConfig, dev: torch.device) -> List:
    """One entry per layer of a ``{"seg{i}": leaves (repeats, count,
    ...)}`` tree, in network order."""
    repeats, segs = period_segments(cfg)
    return [tree_map(lambda a: _tensor(a[r, c], dev), np_tree[f"seg{si}"])
            for r in range(repeats) for si, (_, count) in enumerate(segs)
            for c in range(count)]


def decode_caches_from_jax(np_tree: Params, cfg: ModelConfig, device="cuda"
                           ) -> List[Params]:
    """The reference's decode (or ``forward_full``) caches, ``{"seg{i}":
    {"k", "v", ...} | {"ssm", "conv"}}`` with leaves (repeats, count, B,
    ...), as the port's per-layer list."""
    check_supported(cfg)
    return _unroll(np_tree, cfg, resolve_device(device))


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A copy: the port updates parameters and caches in place."""
    t = t.detach().cpu()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).numpy())


def _stack(layers: List[Params], cfg: ModelConfig) -> Params:
    """Per-layer trees (network order) as ``{"seg{i}": leaves (repeats,
    count, ...)}`` numpy trees, bfloat16 as float32."""
    repeats, segs = period_segments(cfg)
    period = sum(count for _, count in segs)
    out: Params = {}
    start = 0
    for si, (_, count) in enumerate(segs):
        seg = [layers[r * period + start + c]
               for r in range(repeats) for c in range(count)]
        out[f"seg{si}"] = tree_map(
            lambda *ls: np.stack([_numpy(t) for t in ls]).reshape(
                (repeats, count) + tuple(ls[0].shape)), *seg)
        start += count
    return out


def caches_to_jax(caches: List[Params], cfg: ModelConfig) -> Params:
    """The port's per-layer caches as numpy leaves in the reference's
    segment-stacked layout (bfloat16 as float32)."""
    return _stack(caches, cfg)


def params_to_jax(params: Params, cfg: ModelConfig) -> Params:
    """The port's parameters as a numpy tree in the reference's layout
    (the inverse of :func:`params_from_jax`; bfloat16 as float32)."""
    out = {"embed": tree_map(_numpy, params["embed"]),
           "final_norm": _numpy(params["final_norm"]),
           "blocks": _stack(params["layers"], cfg)}
    if cfg.is_encoder_decoder:
        enc = params["encoder"]
        out["encoder"] = {
            "blocks": tree_map(lambda *ls: np.stack(
                [_numpy(t)[None] for t in ls]), *enc["layers"]),
            "final_norm": _numpy(enc["final_norm"])}
    return out
