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


# ---------------------------------------------------------------------------
# a rank's AdamW under a mesh: tensor-parallel slices, data-parallel
# gradients, ZeRO-1 moments
# ---------------------------------------------------------------------------
def zero1_slice(t: torch.Tensor, dim, ds: int, dr: int) -> torch.Tensor:
    """Data rank ``dr``'s block of ``t`` along ``dim`` (None: ``t``)."""
    if dim is None:
        return t
    k = t.shape[dim] // ds
    return t.narrow(dim, dr * k, k)


def init_sharded_adamw(params, dims, ds: int, dr: int) -> AdamWState:
    """Zero moments of data rank ``dr``'s ZeRO-1 blocks of the rank's
    parameter slices (``dims``: ``sharding.zero1_local_dims``)."""
    def zeros(path, p):
        s = zero1_slice(p, dims[path], ds, dr)
        return torch.zeros(s.shape, dtype=torch.float32, device=p.device)
    leaves = {path: p for path, p in tree_paths(params)}
    mu = _rebuild_like(params, [zeros(pt, p) for pt, p in leaves.items()])
    nu = _rebuild_like(params, [zeros(pt, p) for pt, p in leaves.items()])
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=mu, nu=nu)


def _rebuild_like(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _bucketed(tensors, op):
    """Apply ``op`` (one collective on a flat buffer) to ``tensors``
    concatenated per dtype; returns the results split back, in order."""
    out = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, list] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = op(torch.cat([tensors[i].reshape(-1) for i in idx]))
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape)
            off += n
    return out


def copies(tp, params) -> list:
    """Per leaf of the rank's ``params`` (in order): None where the rank
    holds it whole (a copy on every model rank), else (dim, the rank's
    indices along it as a tensor, the number of model ranks holding each
    of them as a float32 tensor) — more than one where a K/V head or an
    SSM group's B/C channels are replicated on several ranks."""
    from repro_torch.distributed.sharding import rank_layout
    lays = [rank_layout(tp.layout.cfg, tp.ms, r) for r in range(tp.ms)]
    out = []
    for path, p in tree_paths(params):
        pl = tp.layout.plan(path, tuple(p.shape))
        if pl is None:
            out.append(None)
            continue
        dim, idx, n = pl
        count = torch.zeros(n, dtype=torch.float32)
        for lay in lays:
            count[lay.plan(path, tuple(p.shape))[1]] += 1
        idx_t = torch.tensor(idx)
        out.append((dim, idx_t.to(p.device), count[idx_t].to(p.device)))
    return out


@torch.no_grad()
def sharded_adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params,
                         tp, dims, *, sum_data: bool = True, held=None
                         ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step on a rank of a tensor- and data-parallel step.
    ``grads``: the rank's gradients of its parameter slices, as the list
    of the params' leaves in order; ``held``: :func:`copies` of the
    params (computed here when None).

    1. ``sum_data``: the gradients are summed over ``data`` (one float32
       all_reduce; each data rank's loss holds its rows' share).
    2. An element held by several model ranks inside a split leaf (a
       replicated K/V head's Wk/Wv columns, an SSM group's B/C columns
       of ``in_xbc`` and the conv) holds a partial gradient on each (its
       own heads' share): the copies are summed over the ranks that hold
       them (one all_reduce over ``model`` of those leaves at full
       width), so they stay equal.
    3. ``global_norm`` counts every element of the full gradient once:
       each element's square is divided by its copies over ``model`` (a
       whole leaf: ms) and the sum taken over ``model``.
    4. ZeRO-1: data rank ``dr`` updates its ``dims`` block of each
       parameter and of the moments (``state``'s leaves are those
       blocks), then the blocks are all-gathered over ``data`` (one
       all_gather per parameter dtype).

    Params and moments are updated in place.  Returns (params, new
    state, {"grad_norm", "lr"})."""
    from repro_torch.distributed.parallel import all_gather, all_reduce
    paths = tree_paths(params)
    held = copies(tp, params) if held is None else held
    g = [x.float() for x in grads]
    ds, dr, ms = tp.ds, tp.data_rank, tp.ms
    if sum_data and tp.data_group is not None:
        g = _bucketed(g, lambda f: all_reduce(f, tp.data_group))
    shared = [i for i, h in enumerate(held)
              if h is not None and bool((h[2] > 1).any())]
    if shared and tp.model_group is not None:
        full = []
        for i in shared:
            dim, idx, count = held[i]
            shape = list(g[i].shape)
            shape[dim] = int(tp.layout.plan(paths[i][0], tuple(
                g[i].shape))[2])
            full.append(g[i].new_zeros(shape).index_copy_(dim, idx, g[i]))
        full = _bucketed(full, lambda f: all_reduce(f, tp.model_group))
        for i, f in zip(shared, full):
            g[i] = f.index_select(held[i][0], held[i][1])

    def sumsq(x, h):
        if h is None:
            return x.square().sum() / ms
        dim, _, count = h
        per = x.square().transpose(0, dim).reshape(x.shape[dim], -1).sum(1)
        return (per / count).sum()
    sq = sum(sumsq(x, h) for x, h in zip(g, held))
    if tp.model_group is not None:
        sq = all_reduce(sq.reshape(1), tp.model_group)[0]
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    gathered = []                         # (param, dim, its new block)
    for (path, p), gi in zip(paths, g):
        dim = dims[path]
        m, v = tree_at(state.mu, path), tree_at(state.nu, path)
        gs = zero1_slice(gi, dim, ds, dr) * scale
        ps = zero1_slice(p, dim, ds, dr)
        m.mul_(cfg.b1).add_((1 - cfg.b1) * gs)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(gs))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if decays(path, p):
            delta = delta + cfg.weight_decay * ps.float()
        new = (ps.float() - lr * delta).to(p.dtype)
        if dim is None:
            p.copy_(new)
        else:
            gathered.append((p, dim, new))
    by_dtype: Dict[torch.dtype, list] = {}
    for item in gathered:
        by_dtype.setdefault(item[2].dtype, []).append(item)
    for items in by_dtype.values():
        flat = torch.cat([n.reshape(-1) for _, _, n in items])
        every = all_gather(flat, tp.data_group, 0)       # (ds · N,)
        off = 0
        for r in range(ds):
            for p, dim, n in items:
                k = n.shape[dim]
                p.narrow(dim, r * k, k).copy_(
                    every[off:off + n.numel()].view(n.shape))
                off += n.numel()
    return params, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
