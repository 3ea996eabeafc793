"""The weight bridge: reference (JAX) parameter trees → the port.

``jax.random`` streams cannot be reproduced in torch, so tests give both
packages the same weights by converting the reference's tree.  The
caller hands over numpy leaves (``jax.tree.map(np.asarray, tree)``);
this module imports neither jax nor the reference package.  bfloat16
leaves (numpy's ``ml_dtypes`` bfloat16) go through an exact float32
round trip.
"""
from __future__ import annotations

from typing import Any, Dict

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
