"""AdamW with gradient clipping and a warmup-cosine schedule, the port
of the reference's ``repro/training/optimizer.py``.

Moments are float32; parameters are updated in their own dtype with no
float32 master copy, as in the reference.  The port updates parameters
and moments IN PLACE (the reference returns new trees and donates the
old ones) and returns the same trees.

Weight decay follows the reference's parameter layout.  The reference
decays every leaf of two or more dimensions, and its per-layer leaves
sit in ``blocks/seg{i}`` stacks with leading (repeats, count) axes, so
every per-layer leaf is decayed there, norm weights, ``conv_b``,
``dt_bias``, ``A_log`` and ``D`` included, while ``final_norm`` is not.
The port keeps one entry per layer, where a layer's norm weight is 1-D:
:func:`decays` therefore decays a leaf under ``layers`` (the decoder's or
the encoder's) or of two or more dimensions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common import (resolve_device, tree_at, tree_leaves,
                                tree_map, tree_paths)
from repro_torch.configs.base import ModelConfig
from repro_torch.models.convert import params_from_jax


class AdamWState(NamedTuple):
    step: torch.Tensor        # () int32
    mu: Any                   # first moment, a tree like the params
    nu: Any                   # second moment


def adamw_state_from_jax(np_state, cfg: ModelConfig, device="cuda"
                         ) -> AdamWState:
    """The reference's ``AdamWState(step, mu, nu)`` (numpy leaves, moments
    shaped like its parameter tree) as the port's, moments in the port's
    per-layer layout."""
    dev = resolve_device(device)
    return AdamWState(
        step=torch.tensor(int(np.asarray(np_state.step)), dtype=torch.int32,
                          device=dev),
        mu=params_from_jax(np_state.mu, cfg, dev),
        nu=params_from_jax(np_state.nu, cfg, dev))


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac * lr``; a float32
    scalar on ``step``'s device (an int: the CPU)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def decays(path: Sequence, p: torch.Tensor) -> bool:
    """Whether the leaf at ``path`` takes weight decay: a per-layer leaf
    (``layers/...`` or ``encoder/layers/...``: the reference's stacked
    leaves, all of two or more dimensions) or any leaf of two or more."""
    return p.dim() >= 2 or "layers" in path[:2]


def init_adamw(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step: float32 moments, params updated in their own dtype.
    ``grads`` is a tree like ``params`` (leaves found by path, whatever
    its key order) or the list of the params' leaves in order.  Params
    and moments are updated in place.  Returns (params, new state,
    {"grad_norm": the norm before clipping, "lr"})."""
    paths = tree_paths(params)
    g_leaves = list(grads) if isinstance(grads, (list, tuple)) \
        else [tree_at(grads, path) for path, _ in paths]
    gnorm = global_norm(g_leaves)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    for (path, p), g in zip(paths, g_leaves):
        m, v = tree_at(state.mu, path), tree_at(state.nu, path)
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if decays(path, p):
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
