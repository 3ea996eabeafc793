"""Step functions and their per-rank shapes for every (architecture ×
input shape) combination, the port of the reference's
``repro/launch/steps.py``.

Three entry points, matching the assigned input shapes:

* ``train_step``   (train_4k)     — loss, backward and AdamW, remat,
  tensor-parallel with ZeRO-1 moments;
* ``prefill_step`` (prefill_32k)  — ``forward_full`` returning the
  last position's logits and the K/V caches / SSM states, with an aLoRA
  adapter and per-token adapter indices;
* ``decode_step``  (decode_32k, long_500k) — one token against dense
  caches (a ring buffer under a window), aLoRA included.

:func:`input_specs` returns meta tensors of the global shapes (the
reference's ``ShapeDtypeStruct``\\ s): nothing here allocates.
:func:`build_step` assembles a :class:`StepSpec`: the function, its
global meta arguments, each argument tree's per-leaf partition specs
(``distributed.sharding``'s rules) and the rank's meta arguments as the
port runs them (``RankLayout.local_shape``, ZeRO-1 blocks, its rows of
the batch, its caches), which ``launch.dryrun`` sizes.  The mesh is a
``DeviceMesh`` (the functions then run on its ranks) or an ``{axis:
size}`` mapping (shapes only).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.common import tree_map, tree_paths
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.alora import PAPER_ALORA_RANK, leaf_shapes
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import batch_axes_of
from repro_torch.models import model as M
from repro_torch.models.layers import dtype_of, padded_vocab
from repro_torch.models.model import Runtime
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import make_train_step

LONG_CONTEXT_WINDOW = 8192
N_ADAPTERS = 1          # adapters stacked into the step


def make_runtime(cfg: ModelConfig, mesh, shape: InputShape,
                 **overrides) -> Runtime:
    """The reference's choices: long_500k gets an 8,192-token window
    where the model has none (pure SSM models need none); MoE layers run
    expert-parallel; training rematerialises each layer."""
    window = 0
    if shape.name == "long_500k" and cfg.arch_type != "ssm" \
            and not cfg.sliding_window:
        window = LONG_CONTEXT_WINDOW
    kw = dict(
        moe_impl="expert_parallel" if cfg.moe is not None else
        "masked_dense",
        mesh=mesh,
        batch_axes=batch_axes_of(mesh),
        model_axis="model",
        remat=(shape.mode == "train"),
        window_override=window,
        q_block=512,
        kv_block=1024,
    )
    kw.update(overrides)
    return Runtime(**kw)


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _extra(cfg: ModelConfig, B: int) -> Optional[torch.Tensor]:
    n = {"vision": cfg.num_patches, "audio": cfg.encoder_seq_len}.get(
        cfg.frontend)
    return None if n is None else _meta((B, n, cfg.d_model), dtype_of(cfg))


def input_specs(cfg: ModelConfig, shape: InputShape,
                rt: Runtime) -> Dict[str, Any]:
    """Meta stand-ins for every model input of this shape, global (the
    whole batch; unsharded caches)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    out: Dict[str, Any] = {}
    extra = _extra(cfg, B)
    if shape.mode == "train":
        out["batch"] = {"tokens": _meta((B, S), i32),
                        "labels": _meta((B, S), i32),
                        "mask": _meta((B, S), torch.float32)}
        if extra is not None:
            out["batch"]["extra_embeds"] = extra
        return out
    if shape.mode == "prefill":
        out["tokens"] = _meta((B, S), i32)
        out["adapter_idx"] = _meta((B, S), i32)
        if extra is not None:
            out["extra_embeds"] = extra
        return out
    # decode: one token against an S-token cache
    out["token"] = _meta((B, 1), i32)
    out["adapter_idx"] = _meta((B, 1), i32)
    out["cache_len"] = _meta((), i32)
    out["caches"] = M.init_decode_caches(
        cfg, B, S, dataclasses.replace(rt, mesh=None), device="meta")
    return out


def adapter_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The stacked adapter tree of ``N_ADAPTERS`` rank-32 adapters and
    the zero slot: leaves (repeats, count, N_ADAPTERS + 1, ...)."""
    repeats, segs = M.period_segments(cfg)
    return {f"seg{si}": {name: _meta((repeats, count, N_ADAPTERS + 1)
                                     + s, dtype_of(cfg))
                         for name, s in leaf_shapes(cfg, PAPER_ALORA_RANK,
                                                    kind).items()}
            for si, (kind, count) in enumerate(segs)}


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------
def make_prefill_fn(cfg: ModelConfig, rt: Runtime):
    def prefill_step(params, adapters, tokens, adapter_idx,
                     extra_embeds=None):
        hidden, _, caches = M.forward_full(
            params, cfg, tokens, rt, adapters=adapters,
            adapter_idx=adapter_idx, extra_embeds=extra_embeds,
            return_caches=True)
        last = hidden[:, -1:]
        cp = M._cp(cfg, rt)
        if cp is not None and cp.model_group is not None:
            # the sequence's last position lives on the last model rank
            from repro_torch.distributed.parallel import all_gather
            last = all_gather(last, cp.model_group, 1)[:, -1:]
        return M.logits_for(params, cfg, last, rt), caches
    return prefill_step


def make_decode_fn(cfg: ModelConfig, rt: Runtime):
    def decode_fn(params, adapters, token, caches, cache_len, adapter_idx):
        return M.decode_step(params, cfg, token, caches, cache_len, rt,
                             adapters=adapters, adapter_idx=adapter_idx)
    return decode_fn


def make_train_fn(cfg: ModelConfig, rt: Runtime,
                  ocfg: AdamWConfig = AdamWConfig()):
    return make_train_step(cfg, ocfg, rt)


# ---------------------------------------------------------------------------
# sharding assembly
# ---------------------------------------------------------------------------
@dataclass
class StepSpec:
    """One (arch × shape × mesh) step: ``fn`` and its global meta
    ``args``; ``specs``: each argument tree's per-leaf partition specs
    (the reference's rules: "params" — ``param_specs_tree``, or
    ``fsdp_param_specs_tree`` under context parallelism — "adapters",
    "mu"/"nu" with ZeRO-1, "caches" — ``cache_specs_tree`` — "batch");
    ``local``: the meta trees one rank (model rank 0, data rank 0)
    holds, as the port lays them out (``RankLayout.local_shape``, its
    ZeRO-1 blocks, its rows of the batch, the K/V heads its query heads
    read); ``outputs``: the rank's meta outputs."""
    fn: Any
    args: tuple
    specs: Dict[str, Any]
    local: Dict[str, Any]
    outputs: Dict[str, Any]
    donate_argnums: tuple = ()


def _rebuild(tree, shape_of):
    out = [_meta(shape_of(path, t), t.dtype) for path, t in tree_paths(tree)]
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


def _rows(n: int, ds: int) -> int:
    return n // ds if n % ds == 0 else n


def build_step(cfg: ModelConfig, shape: InputShape, mesh,
               rt: Optional[Runtime] = None,
               zero1: bool = True) -> StepSpec:
    """Assemble (fn, meta args, specs, the rank's meta trees) for one
    (arch × shape)."""
    rt = rt or make_runtime(cfg, mesh, shape)
    sizes = sh.axis_sizes(mesh)
    ds = 1
    for a in rt.batch_axes:
        ds *= int(sizes.get(a, 1))
    ms = int(sizes.get("model", 1))
    b_axes = rt.batch_axes
    lay = sh.rank_layout(cfg, ms, 0)
    params_shape = M.param_specs(cfg)
    if rt.context_parallel:
        if cfg.arch_type != "dense":
            raise ValueError("context-parallel prefill is implemented for "
                             "dense models")
        pspecs = sh.fsdp_param_specs_tree(cfg, params_shape, sizes)
        fs = dict(sh._paths(pspecs))
        local_params = _rebuild(params_shape, lambda path, t:
                                sh.fsdp_local_shape(tuple(t.shape), fs[path],
                                                    sizes))
    else:
        pspecs = sh.param_specs_tree(cfg, params_shape)
        local_params = _rebuild(params_shape, lambda path, t:
                                lay.local_shape(path, tuple(t.shape)))
    ins = input_specs(cfg, shape, rt)
    B = shape.global_batch
    Bl = _rows(B, ds)

    def rows(t):
        return _meta((_rows(t.shape[0], ds),) + tuple(t.shape[1:]), t.dtype)

    if shape.mode == "train":
        fn = make_train_fn(cfg, rt)
        mu_specs = sh.param_specs_tree(cfg, params_shape)
        if zero1:
            mu_specs = sh.zero1_specs(mu_specs, params_shape, sizes)
        dims = sh.zero1_local_dims(cfg, params_shape, {"data": ds,
                                                       "model": ms}, lay) \
            if zero1 else {p: None for p, _ in tree_paths(params_shape)}

        def block(path, t):
            s = list(lay.local_shape(path, tuple(t.shape)))
            if dims[path] is not None:
                s[dims[path]] //= ds
            return tuple(s)
        moments = tree_map(lambda t: t.to(torch.float32), _rebuild(
            params_shape, block))
        batch = {k: rows(v) for k, v in ins["batch"].items()}
        state = {"params": local_params, "step": _meta((), torch.int32),
                 "mu": moments, "nu": moments}
        bspecs = {k: sh.batch_specs(b_axes)[k] for k in ins["batch"]}
        return StepSpec(
            fn, (params_shape, ins["batch"]),
            {"params": pspecs, "mu": mu_specs, "nu": mu_specs,
             "batch": bspecs},
            {"state": state, "batch": batch},
            {"state": state, "stats": {k: _meta((), torch.float32) for k in
                                       ("loss", "ce", "aux", "grad_norm",
                                        "lr")}},
            donate_argnums=(0,))

    ad_shape = adapter_specs(cfg)
    ad_specs = sh.adapter_specs_tree(cfg, ad_shape)
    local_ad = _rebuild(ad_shape, lambda path, t:
                        lay.local_shape(path, tuple(t.shape)))
    logits = _meta((Bl, 1, padded_vocab(cfg)), dtype_of(cfg))
    if shape.mode == "prefill":
        fn = make_prefill_fn(cfg, rt)
        args = [params_shape, ad_shape, ins["tokens"], ins["adapter_idx"]]
        local = {"params": local_params, "adapters": local_ad,
                 "tokens": rows(ins["tokens"]),
                 "adapter_idx": rows(ins["adapter_idx"])}
        if "extra_embeds" in ins:
            args.append(ins["extra_embeds"])
            local["extra_embeds"] = rows(ins["extra_embeds"])
        caches = _prefill_caches(cfg, shape, rt, Bl, lay, ms)
        cache_sp = sh.cache_specs_tree(cfg, caches, sizes, b_axes)
        return StepSpec(fn, tuple(args),
                        {"params": pspecs, "adapters": ad_specs,
                         "tokens": sh.P(b_axes, None),
                         "caches": cache_sp},
                        local, {"logits": logits, "caches": caches})

    # decode
    fn = make_decode_fn(cfg, rt)
    bsh = B > 1
    cache_sp = sh.cache_specs_tree(cfg, ins["caches"], sizes, b_axes,
                                   batch_shardable=bsh)
    caches = M.init_decode_caches(cfg, B, shape.seq_len, rt, device="meta")
    args = (params_shape, ad_shape, ins["token"], ins["caches"],
            ins["cache_len"], ins["adapter_idx"])
    local = {"params": local_params, "adapters": local_ad,
             "token": rows(ins["token"]), "caches": caches,
             "cache_len": ins["cache_len"],
             "adapter_idx": rows(ins["adapter_idx"])}
    return StepSpec(fn, args,
                    {"params": pspecs, "adapters": ad_specs,
                     "token": sh.P(b_axes, None) if bsh else sh.P(None, None),
                     "caches": cache_sp},
                    local, {"logits": logits, "caches": caches},
                    donate_argnums=(3,))


def _prefill_caches(cfg: ModelConfig, shape: InputShape, rt: Runtime,
                    Bl: int, lay, ms: int):
    """The rank's meta caches of ``forward_full(..., return_caches=True)``
    (K/V over the whole prompt, the patches included; under context
    parallelism its block of the sequence)."""
    from repro_torch.configs.base import SSM
    S = shape.seq_len + (cfg.num_patches if cfg.frontend == "vision" else 0)
    dt = dtype_of(cfg)
    if rt.context_parallel:
        S, kv = S // ms, cfg.num_kv_heads
    else:
        kv = len(lay.kv_heads)
    out = []
    for kind in cfg.pattern():
        if kind == SSM:
            s = cfg.ssm
            _, nh, ch = lay.ssm_local_dims()
            out.append({"ssm": _meta((Bl, nh, s.state_dim, s.head_dim),
                                     torch.float32),
                        "conv": _meta((Bl, s.conv_width - 1, ch), dt)})
            continue
        c = {"k": _meta((Bl, S, kv, cfg.head_dim), dt),
             "v": _meta((Bl, S, kv, cfg.head_dim), dt)}
        if cfg.is_encoder_decoder:
            c["xk"] = _meta((Bl, cfg.encoder_seq_len, kv, cfg.head_dim), dt)
            c["xv"] = _meta((Bl, cfg.encoder_seq_len, kv, cfg.head_dim), dt)
        out.append(c)
    return out
