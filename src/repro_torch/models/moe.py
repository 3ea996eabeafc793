"""Mixture-of-experts MLP sublayer — the port of the reference's
``repro/models/moe.py`` (its exact ``masked_dense`` implementation).

The reference computes the layer with ``jnp.einsum`` inside a
``lax.scan`` over the experts, not with a Pallas kernel, so the port's
products are plain ``torch.matmul``, one batched product per weight
over the expert axis, on the card and on the CPU alike::

    a   = act(x @ w_gate[e]) * (x @ w_up[e])     (E, T, f)
    y_e = a @ w_down[e]                          (E, T, d)
    out = sum_e y_e * w[t, e]                    (T, d)

Every expert runs every row and the routing weight (zero off a row's
top k) scales the expert's output: exact, no capacity, no drops.
``torch.matmul(x[None], w)`` runs ``bmm`` on the weight stacks as they
lie; ``torch.einsum("td,edf->etf", ...)`` would first copy each whole
stack.  The reference adds the experts' outputs one after another in
x's dtype; here the sum over E is one reduction that rounds once, so in
bfloat16 the two differ by rounding (:func:`moe_masked_dense_ref` adds
sequentially and is the oracle of that difference).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import activation_fn

Params = Dict[str, Any]


def init_moe(generator: torch.Generator, cfg: ModelConfig, dtype,
             device) -> Params:
    """One MoE layer's weights with the reference's shapes, dtypes and
    standard deviations (``init_moe``): ``router`` (d, E) in float32,
    ``w_up`` (E, d, f), ``w_down`` (E, f, d) and, for swiglu,
    ``w_gate`` (E, d, f).  Each stack is drawn one expert at a time, so
    the float32 draw never holds more than one expert's matrix."""
    m = cfg.moe
    d, E, f = cfg.d_model, m.num_experts, m.d_ff
    std = 0.02
    out_std = 0.02 / math.sqrt(2 * cfg.num_layers)

    def normal(shape, sd, dt):
        out = torch.empty(shape, dtype=dt, device=device)
        for e in range(shape[0]):
            out[e] = torch.randn(shape[1:], generator=generator,
                                 dtype=torch.float32, device=device) * sd
        return out

    p = {"router": torch.randn((d, E), generator=generator,
                               dtype=torch.float32, device=device) * std,
         "w_up": normal((E, d, f), std, dtype),
         "w_down": normal((E, f, d), out_std, dtype)}
    if cfg.activation == "swiglu":
        p["w_gate"] = normal((E, d, f), std, dtype)
    return p


def route(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
          with_aux: bool = False
          ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Router: float32 logits ``x @ router``, softmax, top k, the k
    weights renormalised by ``clip(sum, 1e-9)``.  Returns (weights
    (..., k) float32, idx (..., k) int64, aux): ``aux`` is the Switch
    load-balance loss ``E * sum_e f_e * p_e * coef`` when ``with_aux``,
    else None (the serving step never reads it)."""
    m = cfg.moe
    E = m.num_experts
    logits = x.float() @ p["router"]
    gates = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(gates, m.experts_per_token, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    aux = None
    if with_aux:
        pe = gates.reshape(-1, E).mean(0)
        fe = F.one_hot(idx, E).float().sum(-2).reshape(-1, E).mean(0)
        aux = E * torch.sum(fe * pe) * m.load_balance_coef
    return weights, idx, aux


def expert_weights(weights: torch.Tensor, idx: torch.Tensor, E: int,
                   dtype) -> torch.Tensor:
    """(T, E) routing weight of each expert for each row, in ``dtype``:
    the row's renormalised gate where the expert is among its top k,
    else 0 (the reference's ``sum_k (idx == e) * weights``, cast)."""
    w = torch.zeros(weights.shape[:-1] + (E,), dtype=torch.float32,
                    device=weights.device)
    return w.scatter_(-1, idx, weights).to(dtype)


def _hidden(p: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """h (..., T, d) against (..., d, f) stacks -> the activation (..., T,
    f) in h's dtype."""
    if cfg.activation == "swiglu":
        return F.silu(torch.matmul(h, p["w_gate"])) \
            * torch.matmul(h, p["w_up"])
    return activation_fn(cfg.activation)(torch.matmul(h, p["w_up"]))


def moe_masked_dense(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                     with_aux: bool = False, experts: Optional[range] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(..., d) -> (..., d), exact, E× the compute of one expert: one
    batched product per weight over the expert axis, then one weighted
    sum over E.  Returns (out, aux) as :func:`route` gives aux.

    ``experts``: the range of experts ``p``'s stacks hold (a rank of a
    sharded step; the router stays whole), whose partial sum is
    returned; None: all of them."""
    E, d = cfg.moe.num_experts, cfg.d_model
    x2 = x.reshape(-1, d)
    weights, idx, aux = route(p, cfg, x2, with_aux=with_aux)
    w = expert_weights(weights, idx, E, x.dtype)              # (T, E)
    if experts is not None:
        w = w[:, experts.start:experts.stop]
    y = torch.matmul(_hidden(p, cfg, x2.unsqueeze(0)), p["w_down"])
    out = (y * w.T.unsqueeze(-1)).sum(0)                     # (T, d)
    return out.reshape(x.shape), aux


def moe_masked_dense_ref(p: Params, cfg: ModelConfig, x: torch.Tensor
                         ) -> torch.Tensor:
    """The reference's order of operations: a loop over experts 0..E-1,
    each expert's output scaled by its weight in x's dtype and added to
    the running sum in x's dtype.  The plain version the card's layer is
    held to."""
    E, d = cfg.moe.num_experts, cfg.d_model
    x2 = x.reshape(-1, d)
    weights, idx, _ = route(p, cfg, x2)
    w = expert_weights(weights, idx, E, x.dtype)
    acc = torch.zeros_like(x2)
    for e in range(E):
        we = {k: v[e] for k, v in p.items() if k != "router"}
        acc = acc + (_hidden(we, cfg, x2) @ we["w_down"]) * w[:, e:e + 1]
    return acc.reshape(x.shape)


def moe_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
              impl: str = "masked_dense", with_aux: bool = False,
              experts: Optional[range] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    if impl == "masked_dense":
        return moe_masked_dense(p, cfg, x, with_aux=with_aux,
                                experts=experts)
    if impl == "expert_parallel":
        raise NotImplementedError(
            "expert-parallel MoE is not ported yet (ROADMAP A14b)")
    raise ValueError(f"unknown moe impl {impl!r}")
