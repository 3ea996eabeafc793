"""Model assembly — the counterpart of the reference's
``repro/models/model.py`` for dense and mixture-of-experts decoder
stacks (a vision prefix enters as prompt embeddings, in the runner),
pure SSM stacks (mamba2), periodic hybrids (zamba2: 5 SSM + 1
attention layer per period) and the encoder-decoder (whisper: a
bidirectional encoder over stub audio-frame embeddings, a causal
decoder whose layers cross-attend to the encoder's output).

Parameters are a plain dictionary::

    {"embed": {"tok": (Vpad, d)[, "unembed": (d, Vpad)]},
     "final_norm": (d,),
     "layers": [{"ln1", "attn": {"wq","wk","wv","wo"}, "ln2",
                 "mlp": {"w_up","w_down"[,"w_gate" (swiglu)]}
                        | "moe": {"router", "w_up", "w_down"[, "w_gate"]}
                 [, "xln", "xattn": {"wq","wk","wv","wo"}]}  # enc-dec
                | {"ln", "ssm": {"in_z", "in_xbc", ...}},  # SSM
                ...]
     [, "encoder": {"layers": [{"ln1", "attn", "ln2", "mlp"}, ...],
                    "final_norm": (d,)}]}                    # enc-dec

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
from repro_torch.models.attention import cross_attention, flash_attention
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.models.ssm import init_ssm

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration no model here can be built from."""
    kinds = set(cfg.pattern())
    if not kinds <= {ATTN, SSM}:
        raise ValueError(f"{cfg.name}: unknown layer kinds "
                         f"{sorted(kinds - {ATTN, SSM})}")
    if SSM in kinds and cfg.ssm is None:
        raise ValueError(f"{cfg.name}: SSM layers need an SSMConfig")
    if cfg.is_encoder_decoder and (SSM in kinds or cfg.num_encoder_layers
                                   <= 0 or cfg.encoder_seq_len <= 0):
        raise ValueError(f"{cfg.name}: an encoder-decoder needs attention "
                         "decoder layers, encoder layers and frames")


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

    def attn():
        return {"wq": normal((d, H * hd), std),
                "wk": normal((d, KV * hd), std),
                "wv": normal((d, KV * hd), std),
                "wo": normal((H * hd, d), out_std)}

    def attn_layer(cross: bool):
        layer = {"ln1": ones(), "attn": attn(), "ln2": ones()}
        if cfg.moe is not None:
            layer["moe"] = init_moe(generator, cfg, dtype, dev)
        else:
            layer["mlp"] = {"w_up": normal((d, cfg.d_ff), std),
                            "w_down": normal((cfg.d_ff, d), out_std)}
            if cfg.activation == "swiglu":  # gated: the reference's init_mlp
                layer["mlp"]["w_gate"] = normal((d, cfg.d_ff), std)
        if cross:
            layer["xln"], layer["xattn"] = ones(), attn()
        return layer

    v = L.padded_vocab(cfg)
    embed = {"tok": normal((v, d), 0.02)}
    if not cfg.tie_embeddings:
        embed["unembed"] = normal((d, v), 0.02)
    layers = [{"ln": ones(), "ssm": init_ssm(generator, cfg, dtype, dev)}
              if kind == SSM else attn_layer(cfg.is_encoder_decoder)
              for kind in cfg.pattern()]
    params = {"embed": embed, "final_norm": ones(), "layers": layers}
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "layers": [attn_layer(False)
                       for _ in range(cfg.num_encoder_layers)],
            "final_norm": ones()}
    return params


def iter_layers(params: Params, cfg: ModelConfig
                ) -> Iterator[Tuple[str, Params]]:
    """Yield (kind, per-layer params) in network order."""
    for kind, lp in zip(cfg.pattern(), params["layers"]):
        yield kind, lp


def attn_sublayer_full(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
    """Bidirectional full-sequence attention sublayer with its residual,
    without an adapter (the encoder's; single device: no context
    parallelism, no remat).  x: (B, S, d); positions: (B, S)."""
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = L.qkv_project(lp["attn"], cfg, h)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=False)
    return x + L.out_project(lp["attn"], cfg, o)


def cross_attn_sublayer(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                        xk: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """Decoder → encoder cross-attention with its residual, given the
    projected encoder K/V (B, Se, KV, hd); x: (B, S, d)."""
    h = L.rmsnorm(x, lp["xln"], cfg.norm_eps)
    q = (h @ lp["xattn"]["wq"]).reshape(
        h.shape[:-1] + (cfg.num_heads, cfg.head_dim))
    return x + L.out_project(lp["xattn"], cfg, cross_attention(q, xk, xv))


def encoder_kv(lp: Params, cfg: ModelConfig, enc_out: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project the encoder output (B, Se, d) to this decoder layer's
    cross K/V, each (B, Se, KV, hd)."""
    B, Se, _ = enc_out.shape
    shape = (B, Se, cfg.num_kv_heads, cfg.head_dim)
    return ((enc_out @ lp["xattn"]["wk"]).reshape(shape),
            (enc_out @ lp["xattn"]["wv"]).reshape(shape))


def run_encoder(enc_params: Params, cfg: ModelConfig, frames: torch.Tensor
                ) -> torch.Tensor:
    """The bidirectional encoder over stub frame embeddings (B, Se, d),
    RoPE on the frame positions as in the reference; returns the final
    normed output in the model dtype."""
    x = frames.to(L.dtype_of(cfg))
    B, Se, _ = x.shape
    positions = torch.arange(Se, device=x.device).expand(B, Se)
    for lp in enc_params["layers"]:
        x = attn_sublayer_full(lp, cfg, x, positions)
        x = mlp_sublayer(lp, cfg, x)
    return L.rmsnorm(x, enc_params["final_norm"], cfg.norm_eps)


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
