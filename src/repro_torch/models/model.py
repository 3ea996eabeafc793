"""Model assembly — the counterpart of the reference's
``repro/models/model.py`` for dense and mixture-of-experts decoder
stacks (a vision prefix enters as prompt embeddings, in the runner),
pure SSM stacks (mamba2) and periodic hybrids (zamba2: 5 SSM + 1
attention layer per period).

Parameters are a plain dictionary::

    {"embed": {"tok": (Vpad, d)[, "unembed": (d, Vpad)]},
     "final_norm": (d,),
     "layers": [{"ln1", "attn": {"wq","wk","wv","wo"}, "ln2",
                 "mlp": {"w_up","w_down"[,"w_gate" (swiglu)]}
                        | "moe": {"router", "w_up", "w_down"[, "w_gate"]}}
                | {"ln", "ssm": {"in_z", "in_xbc", ...}},  # SSM
                ...]}

with one entry per layer in network order — the reference's
``blocks/seg{i}`` stacks unrolled the way its ``iter_layers`` walks them
(``repro_torch.models.convert`` does that unrolling for reference trees).
Every weight keeps the reference's layout, so ``x @ w`` means the same.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Tuple

import torch

from repro_torch.common import resolve_device
from repro_torch.configs.base import ATTN, SSM, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.models.ssm import init_ssm

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the architecture families the port does not run yet,
    naming the ROADMAP item that ports them."""
    kinds = set(cfg.pattern())
    if not kinds <= {ATTN, SSM}:
        raise ValueError(f"{cfg.name}: unknown layer kinds "
                         f"{sorted(kinds - {ATTN, SSM})}")
    if SSM in kinds and cfg.ssm is None:
        raise ValueError(f"{cfg.name}: SSM layers need an SSMConfig")
    for what, present, item in (
            (f"the {cfg.frontend} frontend",
             cfg.frontend not in ("none", "vision"), "A10d"),
            ("encoder-decoder", cfg.is_encoder_decoder, "A10d")):
        if present:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet (ROADMAP {item})")


def effective_window(cfg: ModelConfig) -> int:
    return cfg.sliding_window


def period_segments(cfg: ModelConfig) -> Tuple[int, List[Tuple[str, int]]]:
    """Smallest repeating period of the layer pattern, run-length encoded:
    (repeats, [(kind, count), ...]) with repeats * sum(counts) ==
    num_layers.  The reference stacks its parameters by these segments."""
    pat = cfg.pattern()
    n = len(pat)
    period = pat
    for p in range(1, n + 1):
        if n % p == 0 and pat == pat[:p] * (n // p):
            period = pat[:p]
            break
    segs: List[Tuple[str, int]] = []
    for kind in period:
        if segs and segs[-1][0] == kind:
            segs[-1] = (kind, segs[-1][1] + 1)
        else:
            segs.append((kind, 1))
    return n // len(period), segs


def _normal(gen: torch.Generator, shape, std: float, dtype, device
            ) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * std).to(dtype)


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device="cuda") -> Params:
    """Random weights with the reference's shapes and standard deviations
    (``init_params``/``init_attn``/``init_mlp``/``init_moe``/``init_ssm``/
    ``init_embeddings``), drawn
    from ``generator``, which must live on ``device``.  The values differ
    from the reference's ``jax.random`` streams; tests that compare the
    two packages convert the reference's weights instead."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = L.dtype_of(cfg)
    d, hd, H, KV = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    std, out_std = 0.02, 0.02 / math.sqrt(2 * cfg.num_layers)

    def normal(shape, s):
        return _normal(generator, shape, s, dtype, dev)

    def ones():
        return torch.ones((d,), dtype=dtype, device=dev)

    v = L.padded_vocab(cfg)
    embed = {"tok": normal((v, d), 0.02)}
    if not cfg.tie_embeddings:
        embed["unembed"] = normal((d, v), 0.02)
    layers = []
    for kind in cfg.pattern():
        if kind == SSM:
            layers.append({"ln": ones(),
                           "ssm": init_ssm(generator, cfg, dtype, dev)})
            continue
        layer = {
            "ln1": ones(),
            "attn": {"wq": normal((d, H * hd), std),
                     "wk": normal((d, KV * hd), std),
                     "wv": normal((d, KV * hd), std),
                     "wo": normal((H * hd, d), out_std)},
            "ln2": ones(),
        }
        if cfg.moe is not None:
            layer["moe"] = init_moe(generator, cfg, dtype, dev)
        else:
            layer["mlp"] = {"w_up": normal((d, cfg.d_ff), std),
                            "w_down": normal((cfg.d_ff, d), out_std)}
            if cfg.activation == "swiglu":  # gated: the reference's init_mlp
                layer["mlp"]["w_gate"] = normal((d, cfg.d_ff), std)
        layers.append(layer)
    return {"embed": embed, "final_norm": ones(), "layers": layers}


def iter_layers(params: Params, cfg: ModelConfig
                ) -> Iterator[Tuple[str, Params]]:
    """Yield (kind, per-layer params) in network order."""
    for kind, lp in zip(cfg.pattern(), params["layers"]):
        yield kind, lp


def mlp_sublayer(lp: Params, cfg: ModelConfig, x: torch.Tensor
                 ) -> torch.Tensor:
    """MLP or MoE sublayer with its residual (the reference's dispatch on
    ``cfg.moe``).  The reference also returns the MoE load-balance loss,
    which serving drops; it is not computed here."""
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        return x + moe_apply(lp["moe"], cfg, h)[0]
    return x + L.mlp_apply(lp["mlp"], cfg, h)


def logits_for(params: Params, cfg: ModelConfig, hidden: torch.Tensor
               ) -> torch.Tensor:
    return L.unembed(params["embed"], hidden, cfg.tie_embeddings)
