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

Under ``Runtime.mesh`` both run sharded on one rank of a ``(data,
model)`` mesh: tensor-parallel over ``model`` on ``RankLayout``'s slice
of every weight, adapter and cache (``distributed.parallel``'s
collectives, which carry gradients for training), the batch rows over
``data``, the MoE layers expert-parallel under ``moe_impl=
"expert_parallel"``, and under ``context_parallel`` the sequence over
``model`` with FSDP weights gathered over ``data`` per layer.

aLoRA threads through both as ``(adapters, adapter_idx)``: a
segment-stacked adapter tree with a slot axis and each token's slot (0:
base weights).  Each adapted Q/K/V projection is one fused aLoRA call
(``kernels.alora_qkv``), the SSM input projection's delta the grouped
delta over every slot (``kernels.ragged_lora``); neither kernel has a
backward, so a card call that needs a gradient through them raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Tuple)

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import resolve_device, tree_paths
from repro_torch.configs.base import ATTN, SSM, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import (cross_attention, decode_attention,
                                          dequantize_kv, flash_attention,
                                          flash_attention_remat, quantize_kv,
                                          write_kv_cache)
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.models.ssm import (init_ssm, ssd_decode_step, ssd_forward,
                                    ssm_dims)

Params = Dict[str, Any]


@dataclass(frozen=True)
class Runtime:
    """The reference's ``Runtime`` knobs.  With ``mesh`` (a ``DeviceMesh``
    of ``launch.mesh.make_host_mesh``, or an ``{axis: size}`` mapping for
    the dry run's shape arithmetic) the full-sequence model, the decode
    step and training run sharded: tensor-parallel over ``model``, the
    batch rows over ``data``, the MoE layers expert-parallel under
    ``moe_impl="expert_parallel"`` and, under ``context_parallel``, the
    sequence over ``model`` with the weights FSDP over ``data`` (dense
    decoder-only models).  ``sequence_parallel`` is accepted and read by
    nothing, as in the reference.  ``shard_activations`` is accepted and
    changes nothing: the reference's flag adds sharding hints to XLA
    (``_constrain``), which move no value, and under a mesh the port's
    activations always live in the rank's layout (``RankLayout``: its
    rows over ``data``, its heads and columns over ``model``).  The
    reference's XLA-only ``unroll_layers`` and ``skip_masked_blocks`` are
    left out."""
    moe_impl: str = "masked_dense"      # masked_dense | expert_parallel
    mesh: Any = None
    batch_axes: Tuple[str, ...] = ()
    model_axis: str = "model"
    q_block: int = 512                  # flash_attention_remat's tiles
    kv_block: int = 1024
    capacity_factor: float = 1.25       # expert_parallel's
    remat: bool = False                 # recompute each layer in backward
    window_override: int = 0            # force a sliding window (long_500k)
    shard_activations: bool = False
    sequence_parallel: bool = False
    flash_remat: bool = False           # flash_attention_remat
    kv_cache_quant: bool = False        # int8 decode caches
    context_parallel: bool = False

    def __post_init__(self):
        if self.moe_impl not in ("masked_dense", "expert_parallel"):
            raise ValueError(f"unknown moe impl {self.moe_impl!r}")
        if self.mesh is not None and self.model_axis != "model":
            raise ValueError("the port's meshes name their model axis "
                             f"'model', not {self.model_axis!r}")


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


def effective_window(cfg: ModelConfig, rt: Optional[Runtime] = None) -> int:
    """The attention window (0: none): the configuration's, else
    ``rt.window_override``."""
    if cfg.sliding_window or rt is None:
        return cfg.sliding_window
    return rt.window_override


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
    if device.type == "meta":                           # param_specs
        return torch.empty(shape, dtype=dtype, device=device)
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
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
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


_SPECS: Dict[ModelConfig, Params] = {}


def param_specs(cfg: ModelConfig) -> Params:
    """The parameter tree as meta tensors (shapes and dtypes, no storage,
    no random draws): the reference's ``param_specs`` for the dry run and
    the sharded steps' layout checks.  Cached per configuration."""
    if cfg not in _SPECS:
        _SPECS[cfg] = init_params(torch.Generator(), cfg, device="meta")
    return _SPECS[cfg]


def iter_layers(params: Params, cfg: ModelConfig
                ) -> Iterator[Tuple[str, Params]]:
    """Yield (kind, per-layer params) in network order."""
    for kind, lp in zip(cfg.pattern(), params["layers"]):
        yield kind, lp


# ---------------------------------------------------------------------------
# a rank's share of a step under ``Runtime.mesh``
# ---------------------------------------------------------------------------
def _tp(cfg: ModelConfig, rt: Optional[Runtime]):
    """The rank's ``TensorParallel`` of a tensor-parallel step (None:
    unsharded, or context-parallel)."""
    if rt is None or rt.mesh is None or rt.context_parallel:
        return None
    from repro_torch.distributed.parallel import tensor_parallel
    return tensor_parallel(cfg, rt.mesh)


def _cp(cfg: ModelConfig, rt: Optional[Runtime]):
    """The rank's ``ContextParallel`` (None: not context-parallel)."""
    if rt is None or rt.mesh is None or not rt.context_parallel:
        return None
    from repro_torch.distributed.parallel import context_parallel
    return context_parallel(cfg, rt.mesh, param_specs(cfg))


def check_local(tree, layout, what: str) -> None:
    """Raise unless every leaf of ``tree`` is ``layout``'s slice of it
    (full parameters handed to a sharded step fail here)."""
    for path, t in tree_paths(tree):
        pl = layout.plan(path, tuple(t.shape))
        if pl is not None and t.shape[pl[0]] != len(pl[1]):
            raise ValueError(
                f"{what} {'/'.join(map(str, path))}: shape "
                f"{tuple(t.shape)} is not model rank {layout.mr}'s slice "
                f"(dim {pl[0]}: {len(pl[1])} of {pl[2]}); under "
                "Runtime.mesh pass the rank's slice "
                "(distributed.sharding.shard_params / shard_adapter_layers)")


def local_layout(cfg: ModelConfig, rt: Optional[Runtime], batch: int):
    """(the rank's ``RankLayout`` or None, its rows of a ``batch``-row
    batch) under ``rt.mesh``, a live mesh or an ``{axis: size}``
    mapping (whose rank is model rank 0)."""
    if rt is None or rt.mesh is None or rt.context_parallel:
        return None, batch
    from repro_torch.distributed.parallel import tensor_parallel
    from repro_torch.distributed.sharding import rank_layout
    if isinstance(rt.mesh, Mapping):
        sizes = rt.mesh
        lay = rank_layout(cfg, int(sizes.get("model", 1)), 0)
        ds = math.prod(int(v) for k, v in sizes.items() if k != "model")
    else:
        tp = tensor_parallel(cfg, rt.mesh)
        lay, ds = tp.layout, tp.ds
    return lay, (batch // ds if batch % ds == 0 else batch)


def _enter(tp, x: torch.Tensor, part: str) -> torch.Tensor:
    return x if tp is None else tp.enter(x, part)


def _reduced(y: torch.Tensor, tp, part: str) -> torch.Tensor:
    """``y`` summed over the model axis where ``tp`` (a rank's
    ``distributed.parallel.TensorParallel``) splits ``part``."""
    return y if tp is None else tp.reduce(y, part)


def _embed(params: Params, tokens: torch.Tensor, tp=None, cp=None
           ) -> torch.Tensor:
    if tp is None and cp is None:
        return L.embed(params["embed"], tokens)
    tok = params["embed"]["tok"]
    if cp is not None:
        return cp.param(("embed", "tok"), tok)[tokens]
    return tp.embed(tok, tokens.reshape(-1)).reshape(tokens.shape + (-1,))


def attn_sublayer_full(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                       positions: torch.Tensor, rt: Optional[Runtime] = None,
                       alora: Optional[Params] = None,
                       adapter_idx: Optional[torch.Tensor] = None, *,
                       causal: bool = True, return_kv: bool = False,
                       tp=None, cp=None):
    """Full-sequence attention sublayer with its residual.  x: (B, S, d);
    positions: (B, S).  ``alora``/``adapter_idx``: one layer's stacked
    adapter weights (leading slot axis) and the per-token slot, each Q/K/V
    projection one fused aLoRA call.  Causal attention takes
    :func:`effective_window`; ``rt.flash_remat`` selects the recomputing
    backward.  ``tp``: a rank's share of a sharded step (``cfg`` then
    carries the rank's head counts; Wo's partial sums are reduced).
    ``cp``: a context-parallel rank (x holds its rows of the sequence;
    K/V are gathered over ``model``).  Returns (x, (k, v) after RoPE |
    None)."""
    rt = rt or Runtime()
    h = _enter(tp, L.rmsnorm(x, lp["ln1"], cfg.norm_eps), "attn")
    q, k, v = L.qkv_project(lp["attn"], cfg, h, alora, adapter_idx)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    window = effective_window(cfg, rt) if causal else 0
    if cp is not None:
        o = cp.attention(q, k, v, causal, window)
    elif rt.flash_remat:
        o = flash_attention_remat(q, k, v, causal, window, 0, rt.q_block,
                                  rt.kv_block)
    else:
        o = flash_attention(q, k, v, causal=causal, window=window)
    x = x + _reduced(L.out_project(lp["attn"], cfg, o), tp, "attn")
    return x, ((k, v) if return_kv else None)


def cross_attn_sublayer(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                        xk: torch.Tensor, xv: torch.Tensor, tp=None
                        ) -> torch.Tensor:
    """Decoder → encoder cross-attention with its residual, given the
    projected encoder K/V (B, Se, KV, hd); x: (B, S, d).  ``tp``: as in
    :func:`attn_sublayer_full`."""
    h = _enter(tp, L.rmsnorm(x, lp["xln"], cfg.norm_eps), "attn")
    q = (h @ lp["xattn"]["wq"]).reshape(
        h.shape[:-1] + (cfg.num_heads, cfg.head_dim))
    return x + _reduced(L.out_project(lp["xattn"], cfg,
                                      cross_attention(q, xk, xv)), tp, "attn")


def encoder_kv(lp: Params, cfg: ModelConfig, enc_out: torch.Tensor, tp=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project the encoder output (B, Se, d) to this decoder layer's
    cross K/V, each (B, Se, KV, hd) (the rank's K/V heads under
    ``tp``)."""
    enc_out = _enter(tp, enc_out, "attn")
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
                 tp=None, batch_sharded: bool = False):
    """MLP or MoE sublayer with its residual (the reference's dispatch on
    ``cfg.moe`` and ``rt.moe_impl``).  Returns x; with ``with_aux``, (x,
    aux) as the reference's does: the MoE load-balance loss, a float32
    zero for a dense MLP.  The serving steps leave ``with_aux`` off and
    compute no aux.  ``tp``: a rank's share of a sharded step (its slice
    of the experts or of d_ff; the partial outputs are reduced);
    ``batch_sharded``: x holds this data rank's rows of the batch (the
    aux then takes the data axis's rows too)."""
    rt = rt or Runtime()
    h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        y, aux = moe_apply(lp["moe"], cfg, h, impl=rt.moe_impl,
                           with_aux=with_aux, tp=tp,
                           capacity_factor=rt.capacity_factor,
                           batch_sharded=batch_sharded)
        if rt.moe_impl == "masked_dense":       # the rank's partial sum
            y = _reduced(y, tp, "moe")
    else:
        h = _enter(tp, h, "mlp")
        y = _reduced(L.mlp_apply(lp["mlp"], cfg, h), tp, "mlp")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return (x + y, aux) if with_aux else x + y


def ssm_sublayer_full(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                      alora: Optional[Params] = None,
                      adapter_idx: Optional[torch.Tensor] = None,
                      ssm_state: Optional[torch.Tensor] = None,
                      conv_state: Optional[torch.Tensor] = None, tp=None):
    """SSM sublayer with its residual over whole sequences.  Returns (x,
    the last ssm state, the conv window).  From a zero state (both states
    None) and with no gradient needed, the scan is the dense SSD kernel
    (``ssm.ssd_forward``'s dispatch rule).  ``tp``: a rank's share of a
    sharded step (its SSM heads)."""
    h = _enter(tp, L.rmsnorm(x, lp["ln"], cfg.norm_eps), "ssm")
    y, st, cv = ssd_forward(lp["ssm"], cfg, h, ssm_state=ssm_state,
                            conv_state=conv_state, alora=alora,
                            adapter_idx=adapter_idx, tp=tp)
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


def _take_rows(sl: slice, *ts):
    """Each tensor's rows ``sl``, as a fresh tensor where that is a part
    of them (the kernels take 16-byte-aligned arguments)."""
    return [None if t is None else t if (sl.start, sl.stop) == (0, len(t))
            else t[sl].clone() for t in ts]


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

    Under ``rt.mesh`` every rank passes the whole batch (tokens,
    positions, embeddings, adapter indices) with ITS slice of the
    params and adapters (``distributed.sharding.shard_params`` /
    ``shard_adapter_layers``; anything else raises) and gets back its
    rows of the batch (``TensorParallel.batch_rows``: its block over
    ``data`` when B divides the data axis, else every row).  Under
    ``rt.context_parallel`` the params are its FSDP shards
    (``shard_fsdp_params``) and it gets back its rows and its block of
    the sequence over ``model``.

    Returns (hidden (B, S_total, d), aux (float32 scalar: the MoE
    load-balance losses summed over layers), caches | None), the caches
    one dict per layer in network order: {"k", "v" (B, S_total, KV, hd)
    after RoPE[, "xk", "xv"]} or {"ssm" (B, nh, N, P) float32, "conv" (B,
    W-1, ch)} (the rank's heads under a mesh)."""
    rt = rt or Runtime()
    tp, cp = _tp(cfg, rt), _cp(cfg, rt)
    lcfg = cfg if tp is None else tp.lcfg
    sh = tp or cp
    batch_sharded = False
    if tp is not None:
        check_local(params, tp.layout, "params")
        if adapters is not None:
            check_local(adapters, tp.layout, "adapters")
    if cp is not None:
        cp.check(params, cfg, extra_embeds)
    if sh is not None:
        batch_sharded = sh.batch_sharded(tokens.shape[0])
        tokens, positions, extra_embeds, adapter_idx = _take_rows(
            sh.batch_rows(tokens.shape[0]), tokens, positions, extra_embeds,
            adapter_idx)
    if cp is not None:
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, device=tokens.device).expand(B, S)
        cols = cp.seq_cols(S)
        tokens, positions = tokens[:, cols], positions[:, cols]
        if adapter_idx is not None:
            adapter_idx = adapter_idx[:, cols]
    x = _embed(params, tokens, tp, cp)
    enc_out = None
    if cfg.is_encoder_decoder:
        if extra_embeds is None:
            raise ValueError(f"{cfg.name} needs audio frame embeddings "
                             "(extra_embeds)")
        enc_out = run_encoder(params["encoder"], lcfg, extra_embeds, rt, tp)
    elif extra_embeds is not None:                      # vision: patches
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        if adapter_idx is not None:
            adapter_idx = torch.cat([torch.zeros(
                extra_embeds.shape[:2], dtype=adapter_idx.dtype,
                device=adapter_idx.device), adapter_idx], dim=1)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)

    def layer(i, kind, lp, al):
        def f(x):
            if cp is not None:
                lp_ = cp.gather(("layers", i), lp)
            else:
                lp_ = lp
            if kind == SSM:
                x, st, cv = ssm_sublayer_full(lp_, cfg, x, al, adapter_idx,
                                              tp=tp)
                return x, torch.zeros((), device=x.device), \
                    {"ssm": st, "conv": cv}
            x, (k, v) = attn_sublayer_full(lp_, lcfg, x, positions, rt, al,
                                           adapter_idx, return_kv=True,
                                           tp=tp, cp=cp)
            cache = {"k": k, "v": v}
            if cfg.is_encoder_decoder:
                xk, xv = encoder_kv(lp_, lcfg, enc_out, tp)
                x = cross_attn_sublayer(lp_, lcfg, x, xk, xv, tp)
                cache.update(xk=xk, xv=xv)
            x, aux = mlp_sublayer(lp_, cfg, x, rt, with_aux=True, tp=tp,
                                  batch_sharded=batch_sharded)
            return x, aux, cache
        return f

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = [] if return_caches else None
    for i, ((kind, lp), al) in enumerate(zip(iter_layers(params, cfg),
                                             _layer_adapters(cfg, adapters))):
        f = layer(i, kind, lp, al)
        if rt.remat and torch.is_grad_enabled():
            x, aux, cache = checkpoint(f, x, use_reentrant=False)
        else:
            x, aux, cache = f(x)
        aux_total = aux_total + aux
        if return_caches:
            caches.append(cache)
    final = params["final_norm"] if cp is None \
        else cp.param(("final_norm",), params["final_norm"])
    x = L.rmsnorm(x, final, cfg.norm_eps)
    return x, aux_total, caches


# ---------------------------------------------------------------------------
# decode_step: one token against dense caches
# ---------------------------------------------------------------------------
def _cache_len(cfg: ModelConfig, max_len: int,
               rt: Optional[Runtime] = None) -> int:
    window = effective_window(cfg, rt)
    return min(max_len, window) if window else max_len


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       rt: Optional[Runtime] = None, *, device="cuda"
                       ) -> List[Params]:
    """Zero dense decode caches, one dict per layer in network order:
    attention K/V (B, S_cache, KV, hd) with S_cache = min(max_len, W)
    under a window (:func:`effective_window`; a ring buffer), int8 with
    float32 scales "ks"/"vs" (B, S_cache, KV) under ``rt.kv_cache_quant``,
    and an encoder-decoder's cross K/V (B, encoder_seq_len, KV, hd); SSM
    layers' float32 state (B, nh, N, P) and conv window (B, W-1, ch).

    Under ``rt.mesh`` (a live mesh, or an ``{axis: size}`` mapping for
    the dry run) they are the rank's: its rows of the batch, the K/V
    heads its query heads read (a head replicated on every rank that
    reads it when KV < model), its SSM heads.  ``device="meta"`` gives
    shapes without storage."""
    rt = rt or Runtime()
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    dtype = L.dtype_of(cfg)
    lay, batch = local_layout(cfg, rt, batch)
    kv = cfg.num_kv_heads if lay is None else len(lay.kv_heads)
    s_cache = _cache_len(cfg, max_len, rt)
    kv_shape = (batch, s_cache, kv, cfg.head_dim)
    caches: List[Params] = []
    for kind in cfg.pattern():
        if kind == SSM:
            s = cfg.ssm
            _, nh, ch = ssm_dims(cfg) if lay is None else lay.ssm_local_dims()
            caches.append({
                "ssm": torch.zeros((batch, nh, s.state_dim, s.head_dim),
                                   dtype=torch.float32, device=dev),
                "conv": torch.zeros((batch, s.conv_width - 1, ch),
                                    dtype=dtype, device=dev)})
            continue
        kv_dtype = torch.int8 if rt.kv_cache_quant else dtype
        c = {"k": torch.zeros(kv_shape, dtype=kv_dtype, device=dev),
             "v": torch.zeros(kv_shape, dtype=kv_dtype, device=dev)}
        if rt.kv_cache_quant:
            c["ks"] = torch.zeros(kv_shape[:3], dtype=torch.float32,
                                  device=dev)
            c["vs"] = torch.zeros_like(c["ks"])
        if cfg.is_encoder_decoder:
            c["xk"] = torch.zeros((batch, cfg.encoder_seq_len, kv,
                                   cfg.head_dim), dtype=dtype, device=dev)
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
    returned.  Returns (logits (B, 1, Vpad), caches).

    Under ``rt.mesh``: as :func:`forward_full`, the whole batch's tokens
    and adapter indices with the rank's params, adapters and caches
    (:func:`init_decode_caches` under the same ``rt``); the logits are
    the rank's rows, every column of the padded vocab."""
    rt = rt or Runtime()
    if rt.context_parallel and rt.mesh is not None:
        raise ValueError("context parallelism serves the full-sequence "
                         "prefill (forward_full), not decode_step")
    tp = _tp(cfg, rt)
    lcfg = cfg if tp is None else tp.lcfg
    batch_sharded = False
    if tp is not None:
        check_local(params, tp.layout, "params")
        if adapters is not None:
            check_local(adapters, tp.layout, "adapters")
        batch_sharded = tp.batch_sharded(token.shape[0])
        token, adapter_idx = _take_rows(tp.batch_rows(token.shape[0]),
                                        token, adapter_idx)
        _check_caches(caches, lcfg, tp, token.shape[0])
    x = _embed(params, token, tp)
    B = x.shape[0]
    pos = cache_len
    positions = torch.as_tensor(pos, device=x.device).reshape(1, 1) \
        .expand(B, 1)
    window = effective_window(cfg, rt)
    for (kind, lp), al, cache in zip(iter_layers(params, cfg),
                                     _layer_adapters(cfg, adapters), caches):
        if kind == SSM:
            h = _enter(tp, L.rmsnorm(x, lp["ln"], cfg.norm_eps), "ssm")
            y, st, cv = ssd_decode_step(lp["ssm"], cfg, h, cache["ssm"],
                                        cache["conv"], alora=al,
                                        adapter_idx=adapter_idx, tp=tp)
            cache["ssm"].copy_(st)
            cache["conv"].copy_(cv)
            x = x + y
            continue
        h = _enter(tp, L.rmsnorm(x, lp["ln1"], cfg.norm_eps), "attn")
        q, k, v = L.qkv_project(lp["attn"], lcfg, h, al, adapter_idx)
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
        x = x + _reduced(L.out_project(lp["attn"], lcfg, o), tp, "attn")
        if cfg.is_encoder_decoder:
            x = cross_attn_sublayer(lp, lcfg, x, cache["xk"], cache["xv"],
                                    tp)
        x = mlp_sublayer(lp, cfg, x, rt, tp=tp, batch_sharded=batch_sharded)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return logits_for(params, cfg, x, rt), caches


def _check_caches(caches: List[Params], lcfg: ModelConfig, tp, rows: int
                  ) -> None:
    """Raise unless ``caches`` are the rank's (its rows, K/V heads and
    SSM heads)."""
    nh = tp.layout.ssm_local_dims()[1] if lcfg.ssm is not None else 0
    for i, c in enumerate(caches):
        key, dim, want = ("ssm", 1, nh) if "ssm" in c \
            else ("k", 2, lcfg.num_kv_heads)
        got = c[key].shape
        if got[0] != rows or got[dim] != want:
            raise ValueError(
                f"caches[{i}][{key!r}]: shape {tuple(got)} is not this "
                f"rank's ({rows} rows, {want} heads on dim {dim}); build "
                "them with init_decode_caches or prefill_to_decode_caches "
                "under the same Runtime")


def prefill_to_decode_caches(cfg: ModelConfig, prefill_caches: List[Params],
                             seq_len: int, max_len: int,
                             rt: Optional[Runtime] = None) -> List[Params]:
    """Turn ``forward_full(..., return_caches=True)``'s caches into
    :func:`init_decode_caches`'s layout (model-dtype K/V, as the
    reference's): K/V placed in a max_len cache, or under a window
    (:func:`effective_window` of ``rt``) in the ring buffer's slot ``p %
    W`` for the last min(S, W) tokens.  SSM states are copied
    (``decode_step`` updates its caches in place); cross K/V carry over
    as they are.  A rank's caches stay the rank's."""
    window = effective_window(cfg, rt)
    s_cache = _cache_len(cfg, max_len, rt)
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


def logits_for(params: Params, cfg: ModelConfig, hidden: torch.Tensor,
               rt: Optional[Runtime] = None) -> torch.Tensor:
    """The padded-vocab logits of ``hidden``; under ``rt.mesh`` from the
    rank's vocab slice, gathered over ``model`` (every rank gets every
    column)."""
    tp, cp = _tp(cfg, rt), _cp(cfg, rt)
    emb = params["embed"]
    if cp is not None:
        emb = cp.gather(("embed",), emb)
    if tp is None:
        return L.unembed(emb, hidden, cfg.tie_embeddings)
    logits = L.unembed(emb, tp.enter(hidden, "vocab"), cfg.tie_embeddings)
    return tp.gather_vocab(logits)
