"""Training step: chunked-vocab cross-entropy and AdamW on autograd over
``models.model.forward_full``, the port of the reference's
``repro/training/train_loop.py``.

``make_train_step`` builds a ``(state, batch) -> (state, stats)``
function.  The loss is computed chunk by chunk over the sequence, so the
(B, S, V) float32 logits are never held at once.  The step passes no
adapters: the adapted projections' CUDA kernels have no backward (nor
have the reference's), and a call that would need one raises.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import padded_vocab
from repro_torch.models.model import Runtime, forward_full, logits_for
from repro_torch.common import tree_leaves
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update, init_adamw)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def chunked_ce_loss(params, cfg: ModelConfig, hidden: torch.Tensor,
                    labels: torch.Tensor, mask: torch.Tensor,
                    chunk: int = 512) -> torch.Tensor:
    """Mean masked cross entropy over ``nch = max(S // min(chunk, S), 1)``
    chunks of ``S // nch`` positions: as in the reference, positions past
    ``nch * (S // nch)`` are not scored.  Logits in the model dtype, then
    float32, the padded vocab tail at -1e30.  hidden: (B, S, d)."""
    B, S, _ = hidden.shape
    V, vreal = padded_vocab(cfg), cfg.vocab_size
    nch = max(S // min(chunk, S), 1)
    ch = S // nch
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    pad = torch.arange(V, device=hidden.device) >= vreal
    for c in range(nch):
        sl = slice(c * ch, (c + 1) * ch)
        logits = logits_for(params, cfg, hidden[:, sl]).float()
        if V > vreal:
            logits = logits.masked_fill(pad, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, sl, None].long())[..., 0]
        mc = mask[:, sl].float()
        tot = tot + ((lse - gold) * mc).sum()
        cnt = cnt + mc.sum()
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
    "lr", each a 0-dim tensor on the device."""
    rt = rt or Runtime()

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


def init_train_state(params) -> TrainState:
    return TrainState(params=params, opt=init_adamw(params))
