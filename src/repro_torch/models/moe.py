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
        if out.is_meta:                     # ``model.param_specs``
            return out
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
          with_aux: bool = False, data=None
          ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Router: float32 logits ``x @ router``, softmax, top k, the k
    weights renormalised by ``clip(sum, 1e-9)``.  Returns (weights
    (..., k) float32, idx (..., k) int64, aux): ``aux`` is the Switch
    load-balance loss ``E * sum_e f_e * p_e * coef`` when ``with_aux``,
    else None (the serving step never reads it).  ``data``: (group, n)
    when x holds one data rank's rows of the batch: f_e and p_e are then
    the means over every rank's rows."""
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
        if data is not None:
            from repro_torch.distributed.parallel import mean_over
            pe, fe = mean_over(pe, *data), mean_over(fe, *data)
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


def _data(tp, batch_sharded: bool):
    """(group, size) of the data axis when x holds one data rank's rows."""
    return (tp.data_group, tp.ds) if tp is not None and batch_sharded \
        else None


def moe_masked_dense(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                     with_aux: bool = False, tp=None,
                     batch_sharded: bool = False
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(..., d) -> (..., d), exact, E× the compute of one expert: one
    batched product per weight over the expert axis, then one weighted
    sum over E.  Returns (out, aux) as :func:`route` gives aux.

    ``tp``: a rank's ``TensorParallel`` whose layout splits the experts:
    ``p``'s stacks hold the rank's range of them (the router stays
    whole), and their partial sum is returned; under autograd the
    experts' input and the routing weights carry their gradient summed
    over ``model``.  ``batch_sharded``: x holds the rank's rows of the
    batch (the aux takes every data rank's, as the reference's global
    statistics)."""
    E, d = cfg.moe.num_experts, cfg.d_model
    experts = tp.layout.experts if tp is not None and tp.layout.moe \
        else None
    x2 = x.reshape(-1, d)
    weights, idx, aux = route(p, cfg, x2, with_aux=with_aux,
                              data=_data(tp, batch_sharded))
    w = expert_weights(weights, idx, E, x.dtype)              # (T, E)
    if tp is not None:
        w, x2 = tp.enter(w, "moe"), tp.enter(x2, "moe")
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


def moe_expert_parallel(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                        tp=None, capacity_factor: float = 1.25,
                        batch_sharded: bool = False, with_aux: bool = True
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The reference's ``moe_expert_parallel`` (its shard_map body,
    letter for letter) on one rank: x (B, S, d) the rank's rows (the same
    on every model rank), ``p`` the rank's contiguous experts ``e_lo =
    model_rank · E / ms`` (E divisible by ms) and the whole router.

    Each expert takes at most ``cap = ceil(T·k / E · capacity_factor)``
    assignments of the rank's T tokens; an assignment's place in its
    expert is its rank in the flattened (token, k) order, so the same
    assignments drop as in the reference.  The experts' outputs, scaled
    by the routing weights, are summed over ``model``; ``aux`` is
    averaged over ``data`` where x holds a data rank's rows
    (``batch_sharded``).  ``tp`` None: one rank holding every expert.
    The products are plain ``torch`` batched products (plain XLA in the
    reference)."""
    m = cfg.moe
    E, k = m.num_experts, m.experts_per_token
    ms = 1 if tp is None else tp.ms
    if E % ms:
        raise ValueError(f"{cfg.name}: {E} experts do not divide the model "
                         f"axis {ms}")
    e_loc = E // ms
    e_lo = 0 if tp is None else tp.model_rank * e_loc
    if p["w_up"].shape[0] != e_loc:
        raise ValueError(f"expert stacks of {p['w_up'].shape[0]} experts; "
                         f"this rank holds {e_loc}")
    Bl, S, d = x.shape
    T = Bl * S
    xf = x.reshape(T, d)
    weights, idx, aux = route(p, cfg, xf, with_aux=with_aux)
    if aux is not None and tp is not None and batch_sharded:
        from repro_torch.distributed.parallel import mean_over
        aux = mean_over(aux, tp.data_group, tp.ds)
    cap = int(math.ceil(T * k / E * capacity_factor))
    dev = x.device
    flat_e = idx.reshape(-1)                                 # (T*k,)
    flat_w = weights.reshape(-1)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(k)
    # position of each assignment within its expert
    onehot = F.one_hot(flat_e, E)                            # (T*k, E)
    pos = torch.cumsum(onehot, dim=0) * onehot               # 1-based
    pos_in_e = pos.sum(-1) - 1
    keep = pos_in_e < cap
    mine = (flat_e >= e_lo) & (flat_e < e_lo + e_loc) & keep
    if tp is not None:                # the routing weights feed every rank
        flat_w, xf_e = tp.enter(flat_w, "moe"), tp.enter(xf, "moe")
    else:
        xf_e = xf
    # each assignment's (expert, slot): slot ``cap`` is the dump slot
    slot_e = torch.where(mine, flat_e - e_lo, 0)
    slot_c = torch.where(mine, pos_in_e, cap)
    zero = torch.zeros((), dtype=torch.long, device=dev)
    tok_buf = torch.zeros((e_loc, cap + 1), dtype=torch.long, device=dev) \
        .index_put((slot_e, slot_c), torch.where(mine, flat_tok + 1, zero))
    w_buf = torch.zeros((e_loc, cap + 1), dtype=torch.float32, device=dev) \
        .index_put((slot_e, slot_c),
                   torch.where(mine, flat_w, torch.zeros_like(flat_w)))
    tok_buf, w_buf = tok_buf[:, :cap], w_buf[:, :cap]
    valid = (tok_buf > 0)[..., None].to(x.dtype)
    gather_idx = (tok_buf - 1).clamp_min(0)                  # (e_loc, cap)
    x_e = xf_e[gather_idx] * valid
    y_e = torch.matmul(_hidden(p, cfg, x_e), p["w_down"])
    y_e = y_e * w_buf[..., None].to(y_e.dtype)
    y = torch.zeros((T, d), dtype=x.dtype, device=dev).index_add(
        0, gather_idx.reshape(-1), (y_e * valid).reshape(-1, d))
    if tp is not None:
        y = tp.reduce(y, "moe")
    return y.reshape(Bl, S, d), aux


def moe_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
              impl: str = "masked_dense", with_aux: bool = False,
              tp=None, capacity_factor: float = 1.25,
              batch_sharded: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The reference's dispatch on ``impl``; the rank's place on the mesh
    is ``tp`` (``distributed.parallel.tensor_parallel(cfg, mesh)``; None:
    one rank with every expert).  ``masked_dense`` returns the rank's
    partial sum under ``tp`` (the caller reduces it); ``expert_parallel``
    (x (B, S, d)) returns the sum over every rank's experts."""
    if impl == "masked_dense":
        return moe_masked_dense(p, cfg, x, with_aux=with_aux, tp=tp,
                                batch_sharded=batch_sharded)
    if impl == "expert_parallel":
        return moe_expert_parallel(p, cfg, x, tp=tp,
                                   capacity_factor=capacity_factor,
                                   batch_sharded=batch_sharded,
                                   with_aux=with_aux)
    raise ValueError(f"unknown moe impl {impl!r}")
