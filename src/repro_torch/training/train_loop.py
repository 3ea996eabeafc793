"""Training step: chunked-vocab cross-entropy and AdamW on autograd over
``models.model.forward_full``, the port of the reference's
``repro/training/train_loop.py``.

``make_train_step`` builds a ``(state, batch) -> (state, stats)``
function.  The loss is computed chunk by chunk over the sequence, so the
(B, S, V) float32 logits are never held at once.  The step passes no
adapters: the adapted projections' CUDA kernels have no backward (nor
have the reference's), and a call that would need one raises.  Under
``Runtime.mesh`` the step is tensor- and data-parallel with ZeRO-1
moments (``init_sharded_train_state``; ``gather_train_states`` puts
the ranks' states back together).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import padded_vocab
from repro_torch.common import tree_leaves, tree_map, tree_paths
from repro_torch.distributed.sharding import zero1_local_dims
from repro_torch.models.model import (Runtime, forward_full, logits_for,
                                      param_specs)
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update, copies,
                                            init_adamw, init_sharded_adamw,
                                            sharded_adamw_update)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def _ce_sums(params, cfg: ModelConfig, hidden: torch.Tensor,
             labels: torch.Tensor, mask: torch.Tensor, chunk: int,
             rt: Optional[Runtime] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked cross-entropy sum, mask count) of :func:`chunked_ce_loss`;
    under ``rt.mesh`` the logits come from the rank's vocab slice,
    gathered (``models.model.logits_for``)."""
    B, S, _ = hidden.shape
    V, vreal = padded_vocab(cfg), cfg.vocab_size
    nch = max(S // min(chunk, S), 1)
    ch = S // nch
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    pad = torch.arange(V, device=hidden.device) >= vreal
    for c in range(nch):
        sl = slice(c * ch, (c + 1) * ch)
        logits = logits_for(params, cfg, hidden[:, sl], rt).float()
        if V > vreal:
            logits = logits.masked_fill(pad, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, sl, None].long())[..., 0]
        mc = mask[:, sl].float()
        tot = tot + ((lse - gold) * mc).sum()
        cnt = cnt + mc.sum()
    return tot, cnt


def chunked_ce_loss(params, cfg: ModelConfig, hidden: torch.Tensor,
                    labels: torch.Tensor, mask: torch.Tensor,
                    chunk: int = 512) -> torch.Tensor:
    """Mean masked cross entropy over ``nch = max(S // min(chunk, S), 1)``
    chunks of ``S // nch`` positions: as in the reference, positions past
    ``nch * (S // nch)`` are not scored.  Logits in the model dtype, then
    float32, the padded vocab tail at -1e30.  hidden: (B, S, d)."""
    tot, cnt = _ce_sums(params, cfg, hidden, labels, mask, chunk)
    return tot / torch.clamp(cnt, min=1.0)


def _on(device, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: (torch.from_numpy(np.asarray(v)) if not torch.is_tensor(v)
                else v).to(device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, ocfg: AdamWConfig,
                    rt: Optional[Runtime] = None, loss_chunk: int = 512):
    """Returns ``train_step(state, batch) -> (state, stats)``: the loss
    ``ce + aux`` (aux: the MoE load-balance loss) by autograd over
    ``forward_full``, then one AdamW step in place.  ``batch``: "tokens",
    "labels" (B, S) int, "mask" (B, S) and, for a vision or audio model,
    "extra_embeds" (numpy arrays or tensors; moved to the params'
    device).  A vision model's patch prefix is sliced off the hidden
    states before the loss.  stats: "loss", "ce", "aux", "grad_norm",
    "lr", each a 0-dim tensor on the device.

    Under ``rt.mesh`` (tensor-parallel over ``model``, data-parallel over
    ``data``) see :func:`_sharded_train_step`."""
    rt = rt or Runtime()
    if rt.mesh is not None:
        return _sharded_train_step(cfg, ocfg, rt, loss_chunk)

    def loss_fn(params, batch):
        extra = batch.get("extra_embeds")
        hidden, aux, _ = forward_full(params, cfg, batch["tokens"], rt,
                                      extra_embeds=extra)
        if extra is not None and not cfg.is_encoder_decoder:
            hidden = hidden[:, extra.shape[1]:]
        ce = chunked_ce_loss(params, cfg, hidden, batch["labels"],
                             batch["mask"], loss_chunk)
        return ce + aux, ce, aux

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        ps = tree_leaves(state.params)
        batch = _on(ps[0].device, batch)
        for p in ps:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, ce, aux = loss_fn(state.params, batch)
            grads = torch.autograd.grad(loss, ps)
        for p in ps:
            p.requires_grad_(False)
        params, opt, stats = adamw_update(ocfg, list(grads), state.opt,
                                          state.params)
        stats.update(loss=loss.detach(), ce=ce.detach(), aux=aux.detach())
        return TrainState(params, opt), stats

    return train_step


def _sharded_train_step(cfg: ModelConfig, ocfg: AdamWConfig, rt: Runtime,
                        loss_chunk: int):
    """The train step on one rank of ``rt.mesh``: every rank is given the
    whole batch and its :func:`init_sharded_train_state` (its slice of
    the params, its ZeRO-1 blocks of the moments).  The forward and
    backward run on the rank's rows of the batch and its slices, with
    the collectives that carry gradients (``distributed.parallel``); the
    loss is the masked mean over the GLOBAL batch (each rank's masked
    cross-entropy sum over the all-reduced mask count), and the update
    is ``optimizer.sharded_adamw_update``.  stats are the unsharded
    step's, equal on every rank."""
    from repro_torch.distributed.parallel import all_reduce, tensor_parallel
    if rt.context_parallel:
        raise ValueError("training runs tensor- and data-parallel; "
                         "context parallelism serves the prefill")
    plan: Dict[str, Any] = {}           # built at the first call, on a rank

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if not plan:
            tp = tensor_parallel(cfg, rt.mesh)
            plan.update(tp=tp, dims=zero1_local_dims(
                cfg, param_specs(cfg), rt.mesh, tp.layout),
                held=copies(tp, state.params))
        tp = plan["tp"]
        ps = tree_leaves(state.params)
        batch = _on(ps[0].device, batch)
        B = batch["tokens"].shape[0]
        rows, sharded = tp.batch_rows(B), tp.batch_sharded(B)
        for p in ps:
            p.requires_grad_(True)
        with torch.enable_grad():
            extra = batch.get("extra_embeds")
            hidden, aux, _ = forward_full(state.params, cfg, batch["tokens"],
                                          rt, extra_embeds=extra)
            if extra is not None and not cfg.is_encoder_decoder:
                hidden = hidden[:, extra.shape[1]:]
            tot, cnt = _ce_sums(state.params, cfg, hidden,
                                batch["labels"][rows], batch["mask"][rows],
                                loss_chunk, rt)
            if sharded:
                cnt = all_reduce(cnt.detach().reshape(1), tp.data_group)[0]
            ce = tot / torch.clamp(cnt, min=1.0)
            grads = torch.autograd.grad(ce + aux, ps)
        for p in ps:
            p.requires_grad_(False)
        ce = ce.detach()
        if sharded:
            ce = all_reduce(ce.reshape(1), tp.data_group)[0]
        params, opt, stats = sharded_adamw_update(
            ocfg, list(grads), state.opt, state.params, tp, plan["dims"],
            sum_data=sharded, held=plan["held"])
        stats.update(loss=ce + aux.detach(), ce=ce, aux=aux.detach())
        return TrainState(params, opt), stats

    return train_step


def init_train_state(params) -> TrainState:
    return TrainState(params=params, opt=init_adamw(params))


def init_sharded_train_state(params, cfg: ModelConfig, rt: Runtime
                             ) -> TrainState:
    """A rank's train state under ``rt.mesh``: ``params`` its slice
    (``sharding.shard_params``), zero moments of its ZeRO-1 blocks."""
    from repro_torch.distributed.parallel import tensor_parallel
    tp = tensor_parallel(cfg, rt.mesh)
    dims = zero1_local_dims(cfg, param_specs(cfg), rt.mesh, tp.layout)
    return TrainState(params, init_sharded_adamw(params, dims, tp.ds,
                                                 tp.data_rank))


def gather_train_states(states: List[TrainState], cfg: ModelConfig,
                        sizes) -> TrainState:
    """The whole train state from every rank's (``states`` in rank order
    of a ``(data, model)`` mesh of ``sizes``): params from data rank 0's
    model ranks, moments from every rank's ZeRO-1 blocks."""
    from repro_torch.distributed.sharding import gather_params, rank_layout
    ds, ms = int(sizes.get("data", 1)), int(sizes["model"])
    params = gather_params([s.params for s in states[:ms]], cfg, ms)

    def moments(name):
        per_model = []
        for mr in range(ms):
            dims = zero1_local_dims(cfg, param_specs(cfg), sizes,
                                    rank_layout(cfg, ms, mr))
            blocks = [getattr(states[dr * ms + mr].opt, name)
                      for dr in range(ds)]
            leaves = []
            for i, (path, t0) in enumerate(tree_paths(blocks[0])):
                dim = dims[path]
                leaves.append(t0 if dim is None else torch.cat(
                    [tree_paths(b)[i][1] for b in blocks], dim=dim))
            it = iter(leaves)
            per_model.append(tree_map(lambda _: next(it), blocks[0]))
        return gather_params(per_model, cfg, ms)
    return TrainState(params, AdamWState(states[0].opt.step,
                                         moments("mu"), moments("nu")))
