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

Whole-model passes besides the serving runner's per-layer steps:

* ``forward_full``: the teacher-forced pass over whole sequences (train,
  prefill), optionally returning each layer's K/V or SSM state;
* ``init_decode_caches`` / ``prefill_to_decode_caches`` /
  ``decode_step``: one token at a time against dense caches (a ring
  buffer of W slots under a sliding window; int8 under
  ``Runtime.kv_cache_quant``).  Caches, like the parameters, are one
  dict per layer in network order (the reference stacks them by
  segment), and ``decode_step`` updates them in place.

aLoRA threads through both as ``(adapters, adapter_idx)``: a
segment-stacked adapter tree with a slot axis and each token's slot (0:
base weights).  Each adapted Q/K/V projection is one fused aLoRA call
(``kernels.alora_qkv``), the SSM input projection's delta the grouped
delta over every slot (``kernels.ragged_lora``); neither kernel has a
backward, so a card call that needs a gradient through them raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import resolve_device
from repro_torch.configs.base import ATTN, SSM, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import (cross_attention, decode_attention,
                                          dequantize_kv, flash_attention,
                                          flash_attention_remat, quantize_kv,
                                          write_kv_cache)
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.models.ssm import (init_ssm, init_ssm_state,
                                    ssd_decode_step, ssd_forward)

Params = Dict[str, Any]


_A14_FIELDS = ("moe_impl", "capacity_factor", "mesh", "batch_axes",
               "model_axis", "window_override", "shard_activations",
               "sequence_parallel", "context_parallel")


@dataclass(frozen=True)
class Runtime:
    """The reference's ``Runtime`` knobs for one device.  The fields of
    ``_A14_FIELDS`` (expert parallelism, meshes, sharding, context
    parallelism) exist so that a caller setting them fails loudly: they
    are not ported yet (ROADMAP A14b; the serving engine's sharded mixed
    step is ``EngineConfig.mesh``).  The reference's XLA-only
    ``unroll_layers`` and ``skip_masked_blocks`` are left out."""
    q_block: int = 512                  # flash_attention_remat's tiles
    kv_block: int = 1024
    remat: bool = False                 # recompute each layer in backward
    flash_remat: bool = False           # flash_attention_remat
    kv_cache_quant: bool = False        # int8 decode caches
    # not ported (A14b): any value but the default raises
    moe_impl: str = "masked_dense"      # the other, expert_parallel
    capacity_factor: float = 1.25       # expert_parallel's
    mesh: Any = None
    batch_axes: Tuple[str, ...] = ()
    model_axis: str = "model"
    window_override: int = 0
    shard_activations: bool = False
    sequence_parallel: bool = False
    context_parallel: bool = False

    def __post_init__(self):
        for f in fields(self):
            if f.name in _A14_FIELDS and getattr(self, f.name) != f.default:
                raise NotImplementedError(
                    f"Runtime.{f.name}: expert parallelism, meshes, "
                    "sharding and context parallelism are not ported yet "
                    "(ROADMAP A14b)")


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
    """The attention window (0: none); the reference's
    ``Runtime.window_override`` is not ported (A14b)."""
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
                device="cuda",
                shard: Optional[Callable[[Tuple, Params], Params]] = None
                ) -> Params:
    """Random weights with the reference's shapes and standard deviations
    (``init_params``/``init_attn``/``init_mlp``/``init_moe``/``init_ssm``/
    ``init_embeddings``), drawn
    from ``generator``, which must live on ``device``.  The values differ
    from the reference's ``jax.random`` streams; tests that compare the
    two packages convert the reference's weights instead.

    ``shard(path, subtree)``: applied to the embeddings and to each layer
    as soon as it is drawn (``distributed.sharding.shard_tree`` with a
    rank's layout), so a rank of a sharded engine never holds more than
    one full layer; the draws, and so the values, are the unsharded
    ones."""
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

    keep = shard or (lambda path, tree: tree)
    v = L.padded_vocab(cfg)
    embed = {"tok": normal((v, d), 0.02)}
    if not cfg.tie_embeddings:
        embed["unembed"] = normal((d, v), 0.02)
    embed = keep(("embed",), embed)
    layers = [keep(("layers", i),
                   {"ln": ones(), "ssm": init_ssm(generator, cfg, dtype, dev)}
                   if kind == SSM else attn_layer(cfg.is_encoder_decoder))
              for i, kind in enumerate(cfg.pattern())]
    params = {"embed": embed, "final_norm": ones(), "layers": layers}
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "layers": [keep(("encoder", "layers", i), attn_layer(False))
                       for i in range(cfg.num_encoder_layers)],
            "final_norm": ones()}
    return params


def iter_layers(params: Params, cfg: ModelConfig
                ) -> Iterator[Tuple[str, Params]]:
    """Yield (kind, per-layer params) in network order."""
    for kind, lp in zip(cfg.pattern(), params["layers"]):
        yield kind, lp


def _reduced(y: torch.Tensor, tp, part: str) -> torch.Tensor:
    """``y`` summed over the model axis where ``tp`` (a rank's
    ``distributed.parallel.TensorParallel``) splits ``part``."""
    return y if tp is None else tp.reduce(y, part)


def attn_sublayer_full(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                       positions: torch.Tensor, rt: Optional[Runtime] = None,
                       alora: Optional[Params] = None,
                       adapter_idx: Optional[torch.Tensor] = None, *,
                       causal: bool = True, return_kv: bool = False,
                       tp=None):
    """Full-sequence attention sublayer with its residual.  x: (B, S, d);
    positions: (B, S).  ``alora``/``adapter_idx``: one layer's stacked
    adapter weights (leading slot axis) and the per-token slot, each Q/K/V
    projection one fused aLoRA call.  Causal attention takes the
    configuration's window; ``rt.flash_remat`` selects the recomputing
    backward.  ``tp``: a rank's share of a sharded step (``cfg`` then
    carries the rank's head counts; Wo's partial sums are reduced).
    Returns (x, (k, v) after RoPE | None)."""
    rt = rt or Runtime()
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = L.qkv_project(lp["attn"], cfg, h, alora, adapter_idx)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    window = effective_window(cfg) if causal else 0
    if rt.flash_remat:
        o = flash_attention_remat(q, k, v, causal, window, 0, rt.q_block,
                                  rt.kv_block)
    else:
        o = flash_attention(q, k, v, causal=causal, window=window)
    x = x + _reduced(L.out_project(lp["attn"], cfg, o), tp, "attn")
    return x, ((k, v) if return_kv else None)


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


def run_encoder(enc_params: Params, cfg: ModelConfig, frames: torch.Tensor,
                rt: Optional[Runtime] = None, tp=None) -> torch.Tensor:
    """The bidirectional encoder over stub frame embeddings (B, Se, d),
    RoPE on the frame positions as in the reference; returns the final
    normed output in the model dtype.  ``tp``: as in
    :func:`attn_sublayer_full`."""
    x = frames.to(L.dtype_of(cfg))
    B, Se, _ = x.shape
    positions = torch.arange(Se, device=x.device).expand(B, Se)
    for lp in enc_params["layers"]:
        x, _ = attn_sublayer_full(lp, cfg, x, positions, rt, causal=False,
                                  tp=tp)
        x = mlp_sublayer(lp, cfg, x, rt, tp=tp)
    return L.rmsnorm(x, enc_params["final_norm"], cfg.norm_eps)


def mlp_sublayer(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                 rt: Optional[Runtime] = None, *, with_aux: bool = False,
                 tp=None):
    """MLP or MoE sublayer with its residual (the reference's dispatch on
    ``cfg.moe``).  Returns x; with ``with_aux``, (x, aux) as the
    reference's does: the MoE load-balance loss, a float32 zero for a
    dense MLP.  The serving steps leave ``with_aux`` off and compute no
    aux.  ``tp``: a rank's share of a sharded step (its slice of the
    experts or of d_ff; the partial outputs are reduced)."""
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        y, aux = moe_apply(lp["moe"], cfg, h,
                           impl=(rt or Runtime()).moe_impl,
                           with_aux=with_aux,
                           experts=None if tp is None or not tp.layout.moe
                           else tp.layout.experts)
        y = _reduced(y, tp, "moe")
    else:
        y = _reduced(L.mlp_apply(lp["mlp"], cfg, h), tp, "mlp")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return (x + y, aux) if with_aux else x + y


def ssm_sublayer_full(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                      alora: Optional[Params] = None,
                      adapter_idx: Optional[torch.Tensor] = None,
                      ssm_state: Optional[torch.Tensor] = None,
                      conv_state: Optional[torch.Tensor] = None):
    """SSM sublayer with its residual over whole sequences.  Returns (x,
    the last ssm state, the conv window).  From a zero state (both states
    None) and with no gradient needed, the scan is the dense SSD kernel
    (``ssm.ssd_forward``'s dispatch rule)."""
    h = L.rmsnorm(x, lp["ln"], cfg.norm_eps)
    y, st, cv = ssd_forward(lp["ssm"], cfg, h, ssm_state=ssm_state,
                            conv_state=conv_state, alora=alora,
                            adapter_idx=adapter_idx)
    return x + y, st, cv


def per_layer_adapters(cfg: ModelConfig, stacked: Params) -> List[Params]:
    """Slice a segment-stacked adapter tree (``core.alora.stack_adapters``:
    leaves (repeats, count[, slots], ...)) into one dict per model layer,
    in network order; leaves keep any slot axis."""
    out: List[Params] = []
    repeats, segs = period_segments(cfg)
    for r in range(repeats):
        for si, (_, count) in enumerate(segs):
            seg = stacked[f"seg{si}"]
            for c in range(count):
                out.append({k: v[r, c] for k, v in seg.items()})
    return out


def _layer_adapters(cfg: ModelConfig, adapters: Optional[Params]
                    ) -> List[Optional[Params]]:
    return [None] * cfg.num_layers if adapters is None \
        else per_layer_adapters(cfg, adapters)


# ---------------------------------------------------------------------------
# forward_full: train / prefill
# ---------------------------------------------------------------------------
def forward_full(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 rt: Optional[Runtime] = None, *,
                 positions: Optional[torch.Tensor] = None,
                 extra_embeds: Optional[torch.Tensor] = None,
                 adapters: Optional[Params] = None,
                 adapter_idx: Optional[torch.Tensor] = None,
                 return_caches: bool = False):
    """Teacher-forced pass over whole sequences.  tokens: (B, S) int.

    ``extra_embeds``: a vision model's (B, num_patches, d) patch
    embeddings, prepended to the token embeddings (ordinary prefix
    positions, adapter slot 0), or an encoder-decoder's (B,
    encoder_seq_len, d) audio frames, which the encoder consumes and
    every decoder layer cross-attends to.  ``adapters``: a
    segment-stacked adapter tree with a slot axis, ``adapter_idx`` (B, S)
    each token's slot (0: base weights).  ``rt.remat`` recomputes each
    layer in the backward (``torch.utils.checkpoint``).

    Returns (hidden (B, S_total, d), aux (float32 scalar: the MoE
    load-balance losses summed over layers), caches | None), the caches
    one dict per layer in network order: {"k", "v" (B, S_total, KV, hd)
    after RoPE[, "xk", "xv"]} or {"ssm" (B, nh, N, P) float32, "conv" (B,
    W-1, ch)}."""
    rt = rt or Runtime()
    x = L.embed(params["embed"], tokens)
    enc_out = None
    if cfg.is_encoder_decoder:
        if extra_embeds is None:
            raise ValueError(f"{cfg.name} needs audio frame embeddings "
                             "(extra_embeds)")
        enc_out = run_encoder(params["encoder"], cfg, extra_embeds, rt)
    elif extra_embeds is not None:                      # vision: patches
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        if adapter_idx is not None:
            adapter_idx = torch.cat([torch.zeros(
                extra_embeds.shape[:2], dtype=adapter_idx.dtype,
                device=adapter_idx.device), adapter_idx], dim=1)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)

    def layer(kind, lp, al):
        def f(x):
            if kind == SSM:
                x, st, cv = ssm_sublayer_full(lp, cfg, x, al, adapter_idx)
                return x, torch.zeros((), device=x.device), \
                    {"ssm": st, "conv": cv}
            x, (k, v) = attn_sublayer_full(lp, cfg, x, positions, rt, al,
                                           adapter_idx, return_kv=True)
            cache = {"k": k, "v": v}
            if cfg.is_encoder_decoder:
                xk, xv = encoder_kv(lp, cfg, enc_out)
                x = cross_attn_sublayer(lp, cfg, x, xk, xv)
                cache.update(xk=xk, xv=xv)
            x, aux = mlp_sublayer(lp, cfg, x, rt, with_aux=True)
            return x, aux, cache
        return f

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = [] if return_caches else None
    for (kind, lp), al in zip(iter_layers(params, cfg),
                              _layer_adapters(cfg, adapters)):
        f = layer(kind, lp, al)
        if rt.remat and torch.is_grad_enabled():
            x, aux, cache = checkpoint(f, x, use_reentrant=False)
        else:
            x, aux, cache = f(x)
        aux_total = aux_total + aux
        if return_caches:
            caches.append(cache)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, aux_total, caches


# ---------------------------------------------------------------------------
# decode_step: one token against dense caches
# ---------------------------------------------------------------------------
def _cache_len(cfg: ModelConfig, max_len: int) -> int:
    window = effective_window(cfg)
    return min(max_len, window) if window else max_len


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       rt: Optional[Runtime] = None, *, device="cuda"
                       ) -> List[Params]:
    """Zero dense decode caches, one dict per layer in network order:
    attention K/V (B, S_cache, KV, hd) with S_cache = min(max_len, W)
    under a window (a ring buffer), int8 with float32 scales "ks"/"vs"
    (B, S_cache, KV) under ``rt.kv_cache_quant``, and an
    encoder-decoder's cross K/V (B, encoder_seq_len, KV, hd); SSM layers'
    float32 state (B, nh, N, P) and conv window (B, W-1, ch)."""
    rt = rt or Runtime()
    dev = resolve_device(device)
    dtype = L.dtype_of(cfg)
    s_cache = _cache_len(cfg, max_len)
    kv_shape = (batch, s_cache, cfg.num_kv_heads, cfg.head_dim)
    caches: List[Params] = []
    for kind in cfg.pattern():
        if kind == SSM:
            st, cv = init_ssm_state(cfg, batch, dev)
            caches.append({"ssm": st, "conv": cv})
            continue
        kv_dtype = torch.int8 if rt.kv_cache_quant else dtype
        c = {"k": torch.zeros(kv_shape, dtype=kv_dtype, device=dev),
             "v": torch.zeros(kv_shape, dtype=kv_dtype, device=dev)}
        if rt.kv_cache_quant:
            c["ks"] = torch.zeros(kv_shape[:3], dtype=torch.float32,
                                  device=dev)
            c["vs"] = torch.zeros_like(c["ks"])
        if cfg.is_encoder_decoder:
            c["xk"] = torch.zeros((batch, cfg.encoder_seq_len,
                                   cfg.num_kv_heads, cfg.head_dim),
                                  dtype=dtype, device=dev)
            c["xv"] = torch.zeros_like(c["xk"])
        caches.append(c)
    return caches


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                caches: List[Params], cache_len, rt: Optional[Runtime] = None,
                *, adapters: Optional[Params] = None,
                adapter_idx: Optional[torch.Tensor] = None):
    """One autoregressive step.  token: (B, 1) int; ``cache_len``: the
    tokens already in the caches (an int or a 0-dim tensor; the new token
    is written at that position).  The caches are updated IN PLACE and
    returned.  Returns (logits (B, 1, Vpad), caches)."""
    rt = rt or Runtime()
    x = L.embed(params["embed"], token)
    B = x.shape[0]
    pos = cache_len
    positions = torch.as_tensor(pos, device=x.device).reshape(1, 1) \
        .expand(B, 1)
    window = effective_window(cfg)
    for (kind, lp), al, cache in zip(iter_layers(params, cfg),
                                     _layer_adapters(cfg, adapters), caches):
        if kind == SSM:
            h = L.rmsnorm(x, lp["ln"], cfg.norm_eps)
            y, st, cv = ssd_decode_step(lp["ssm"], cfg, h, cache["ssm"],
                                        cache["conv"], alora=al,
                                        adapter_idx=adapter_idx)
            cache["ssm"].copy_(st)
            cache["conv"].copy_(cv)
            x = x + y
            continue
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = L.qkv_project(lp["attn"], cfg, h, al, adapter_idx)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        n = pos + 1
        if rt.kv_cache_quant:
            (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
            write_kv_cache(cache["k"], cache["v"], kq, vq, pos,
                           window=window)
            write_kv_cache(cache["ks"][..., None], cache["vs"][..., None],
                           ks[..., None], vs[..., None], pos, window=window)
            o = decode_attention(
                q, dequantize_kv(cache["k"], cache["ks"], k.dtype),
                dequantize_kv(cache["v"], cache["vs"], v.dtype), n,
                window=window)
        else:
            write_kv_cache(cache["k"], cache["v"], k, v, pos, window=window)
            o = decode_attention(q, cache["k"], cache["v"], n,
                                 window=window)
        x = x + L.out_project(lp["attn"], cfg, o)
        if cfg.is_encoder_decoder:
            x = cross_attn_sublayer(lp, cfg, x, cache["xk"], cache["xv"])
        x = mlp_sublayer(lp, cfg, x, rt)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return logits_for(params, cfg, x), caches


def prefill_to_decode_caches(cfg: ModelConfig, prefill_caches: List[Params],
                             seq_len: int, max_len: int) -> List[Params]:
    """Turn ``forward_full(..., return_caches=True)``'s caches into
    :func:`init_decode_caches`'s layout (model-dtype K/V, as the
    reference's): K/V placed in a max_len cache, or under a window in the
    ring buffer's slot ``p % W`` for the last min(S, W) tokens.  SSM
    states are copied (``decode_step`` updates its caches in place);
    cross K/V carry over as they are.  (The reference's ``rt`` argument
    only carries its window override, A14b.)"""
    window = effective_window(cfg)
    s_cache = _cache_len(cfg, max_len)
    S = seq_len

    def place(a):                                       # (B, S, KV, hd)
        out = torch.zeros(a.shape[:1] + (s_cache,) + a.shape[2:],
                          dtype=a.dtype, device=a.device)
        if not window or S <= s_cache:
            n = min(S, s_cache)
            out[:, :n] = a[:, :n]
        else:
            pos = torch.arange(S - s_cache, S, device=a.device)
            out[:, pos % s_cache] = a[:, S - s_cache:S]
        return out

    new: List[Params] = []
    for c in prefill_caches:
        if "ssm" in c:
            new.append({"ssm": c["ssm"].clone(), "conv": c["conv"].clone()})
            continue
        e = {"k": place(c["k"]), "v": place(c["v"])}
        if "xk" in c:
            e.update(xk=c["xk"], xv=c["xv"])
        new.append(e)
    return new


def logits_for(params: Params, cfg: ModelConfig, hidden: torch.Tensor
               ) -> torch.Tensor:
    return L.unembed(params["embed"], hidden, cfg.tie_embeddings)
