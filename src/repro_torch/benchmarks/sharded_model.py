"""The sharded full-sequence model's equivalence workload: the same
functions run unsharded (``rt.mesh`` None) and on a rank of a mesh
(``distributed.spawn.launch``), so the tests (against the reference on
the CPU) and the chip smoke (against the port's unsharded card run)
compare like with like.  Nothing here imports JAX: the ranks import it.

Every case takes the FULL weights and cuts the rank's slice itself
(``shard_params`` / ``shard_adapter_layers`` / ``shard_fsdp_params`` /
``shard_train_state``), gathers the rank's rows of every output back
over ``data`` (and the context-parallel sequence blocks over
``model``), and returns CPU tensors (numpy arrays from
:func:`run_cases`):

* :func:`model_case`: ``forward_full`` (with caches) then greedy
  ``decode_step``\\ s: hidden states, each step's logits and tokens;
* :func:`moe_case`: one MoE layer under ``moe_impl="expert_parallel"``:
  the rank's rows of the output and aux;
* :func:`cp_case`: a context-parallel ``forward_full`` and the gradients
  of ``sum(hidden · R)`` with respect to the rank's FSDP shards;
* :func:`train_case`: one tensor-parallel + ZeRO-1 train step: stats
  and the rank's state;
* :func:`step_case`: one ``launch.steps`` step and its collectives.

:func:`run_cases` is the rank entry: ``(name, function, keywords)``
triples, each case's kernel launches and collectives counted from 0.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch


def _rt(mesh, **kw):
    from repro_torch.models.model import Runtime
    return Runtime(mesh=mesh, batch_axes=("data",) if mesh is not None
                   else (), **kw)


def _tensor(a, device, dtype=None):
    if a is None:
        return None
    t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=dtype)


def _rows_gathered(x: torch.Tensor, tp, n: int) -> torch.Tensor:
    """The whole batch's rows of ``x`` (the rank's rows of an ``n``-row
    batch)."""
    from repro_torch.distributed.parallel import all_gather
    if tp is None or not tp.batch_sharded(n):
        return x
    return all_gather(x, tp.data_group, 0)


def _slices(cfg, params, adapters, mesh, coords, device):
    from repro_torch.common import tree_map
    from repro_torch.distributed.sharding import (shard_adapter_layers,
                                                  shard_params)
    if mesh is None:
        def put(t):
            return t.to(device).clone()
        return tree_map(put, params), \
            None if adapters is None else tree_map(put, adapters)
    return (shard_params(params, cfg, mesh, coords, device),
            None if adapters is None
            else shard_adapter_layers(adapters, cfg, mesh, coords, device))


@torch.no_grad()
def model_case(cfg, params, inputs: Dict[str, Any], *, adapters=None,
               mesh=None, coords=None, device="cpu", decode: int = 8,
               rt_kw: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """``forward_full`` over ``inputs`` ("tokens" (B, S), optional
    "adapter_idx", "extra_embeds"), caches to decode caches, then
    ``decode`` greedy ``decode_step``\\ s (on adapter slot 1 where
    adapters are given) from the last position's argmax.  Returns the
    hidden states (B, S_total, d), the logits of the last prefill
    position and of every decode step (decode + 1, B, Vpad) and the
    greedy tokens (decode + 1, B), all rows, float32 on the CPU."""
    from repro_torch.models import model as M
    rt = _rt(mesh, **(rt_kw or {}))
    p, ad = _slices(cfg, params, adapters, mesh, coords, device)
    tp = M._tp(cfg, rt)
    toks = _tensor(inputs["tokens"], device, torch.long)
    B = toks.shape[0]
    aidx = _tensor(inputs.get("adapter_idx"), device, torch.int32)
    ex = _tensor(inputs.get("extra_embeds"), device)
    h, _, caches = M.forward_full(p, cfg, toks, rt, extra_embeds=ex,
                                  adapters=ad, adapter_idx=aidx,
                                  return_caches=True)
    S = h.shape[1]
    logits = [_rows_gathered(M.logits_for(p, cfg, h[:, -1:], rt), tp, B)]
    hidden = _rows_gathered(h, tp, B)
    caches = M.prefill_to_decode_caches(cfg, caches, S, S + decode, rt)
    tok = logits[0].argmax(-1)
    toks_out = [tok[:, 0]]
    on = None if ad is None else torch.ones((B, 1), dtype=torch.int32,
                                            device=device)
    for i in range(decode):
        lg, caches = M.decode_step(p, cfg, tok, caches, S + i, rt,
                                   adapters=ad, adapter_idx=on)
        lg = _rows_gathered(lg, tp, B)
        logits.append(lg)
        tok = lg.argmax(-1)
        toks_out.append(tok[:, 0])
    return {"hidden": hidden.float().cpu(),
            "logits": torch.stack([x[:, 0] for x in logits]).float().cpu(),
            "tokens": torch.stack(toks_out).cpu()}


@torch.no_grad()
def moe_case(cfg, moe_params, x, *, capacity_factor: float, mesh=None,
             coords=None, device="cpu") -> Dict[str, Any]:
    """One MoE layer (``moe_params``: layer 0's "moe" subtree, full) on x
    (B, S, d) under ``expert_parallel``: the rank's rows of the batch (its
    data block where B divides the data axis) and its experts.  Returns
    the output rows, aux and the rows' slice."""
    from repro_torch.distributed.parallel import tensor_parallel
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.models.moe import moe_apply
    x = _tensor(x, device)
    tp = None if mesh is None else tensor_parallel(cfg, mesh)
    p = {k: v.to(device) for k, v in moe_params.items()}
    rows = slice(0, x.shape[0])
    if tp is not None:
        p = shard_tree(p, tp.layout, device)
        rows = tp.batch_rows(x.shape[0])
    y, aux = moe_apply(p, cfg, x[rows], impl="expert_parallel",
                       with_aux=True, tp=tp, capacity_factor=capacity_factor,
                       batch_sharded=tp is not None
                       and tp.batch_sharded(x.shape[0]))
    return {"y": y.float().cpu(), "aux": float(aux),
            "rows": (rows.start, rows.stop)}


def cp_case(cfg, params, tokens, weight, *, mesh=None, coords=None,
            device="cpu") -> Dict[str, Any]:
    """A context-parallel ``forward_full`` (``mesh`` None: the plain
    unsharded one) of ``tokens`` (B, S) and the gradients of
    ``sum(hidden · weight)`` (``weight`` (B, S, d)) with respect to the
    rank's FSDP shards of the params.  Returns the whole hidden states
    and the whole gradients (gathered), float32 on the CPU."""
    from repro_torch.common import tree_leaves, tree_map
    from repro_torch.distributed.parallel import all_gather
    from repro_torch.distributed.sharding import shard_fsdp_params
    from repro_torch.models import model as M
    rt = _rt(mesh, context_parallel=mesh is not None)
    if mesh is None:
        p = tree_map(lambda t: t.to(device).clone(), params)
    else:
        p = shard_fsdp_params(params, cfg, mesh, coords, device)
    toks = _tensor(tokens, device, torch.long)
    w = _tensor(weight, device, torch.float32)
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    with torch.enable_grad():
        h, _, _ = M.forward_full(p, cfg, toks, rt)
        cp = M._cp(cfg, rt)
        if cp is not None:
            w = w[cp.batch_rows(toks.shape[0]), cp.seq_cols(toks.shape[1])]
        grads = torch.autograd.grad((h.float() * w).sum(), leaves,
                                    allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    h = h.detach()
    if cp is not None:
        h = h if cp.model_group is None else all_gather(h, cp.model_group, 1)
        if cp.batch_sharded(toks.shape[0]):
            h = all_gather(h, cp.data_group, 0)
        specs = {path: sh for path, sh in cp.sharded.items()}
        from repro_torch.common import tree_paths
        grads = [g if not specs[path] or cp.data_group is None
                 else all_gather(g, cp.data_group, 0)
                 for (path, _), g in zip(tree_paths(p), grads)]
    it = iter([g.float().cpu() for g in grads])
    return {"hidden": h.float().cpu(),
            "grads": tree_map(lambda _: next(it), p)}


def train_case(cfg, params, batch, *, mesh=None, coords=None, device="cpu",
               ocfg=None, rt_kw: Optional[dict] = None) -> Dict[str, Any]:
    """One train step from ``params`` (full) and zero moments, the
    tensor-parallel + ZeRO-1 step on a rank of ``mesh``.  Returns the
    stats as floats and the (rank's) state: "params", "step", "mu",
    "nu"."""
    from repro_torch.common import tree_map
    from repro_torch.distributed.sharding import shard_params
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import (init_sharded_train_state,
                                                 init_train_state,
                                                 make_train_step)
    rt = _rt(mesh, **(rt_kw or {}))
    if mesh is None:
        state = init_train_state(tree_map(lambda t: t.to(device).clone(),
                                          params))
    else:
        # copies: a whole leaf of ``shard_params`` is the caller's tensor
        # (shared memory between the ranks of ``launch``), and the step
        # updates it in place
        state = init_sharded_train_state(tree_map(
            torch.clone, shard_params(params, cfg, mesh, coords, device)),
            cfg, rt)
    step = make_train_step(cfg, ocfg or AdamWConfig(total_steps=10), rt,
                           loss_chunk=16)
    state, stats = step(state, {k: _tensor(v, device)
                                for k, v in batch.items()})
    return {"stats": {k: float(v) for k, v in stats.items()},
            "params": state.params, "step": int(state.opt.step),
            "mu": state.opt.mu, "nu": state.opt.nu}


def step_case(cfg, params, mode: str, batch: int, seq: int, *, mesh=None,
              coords=None, device="cpu", rt_kw: Optional[dict] = None
              ) -> Dict[str, Any]:
    """One ``launch.steps`` step of ``mode`` ("prefill", "decode",
    "train") on random inputs of the global shape (batch, seq), with the
    rank's slices; returns the collectives of that call alone
    (``parallel.COLLECTIVES``), which ``hlo_analysis.step_collectives``
    predicts."""
    from repro_torch.common import tree_map
    from repro_torch.distributed import parallel
    from repro_torch.distributed.sharding import (shard_fsdp_params,
                                                  shard_params)
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.training.train_loop import init_sharded_train_state
    rt = _rt(mesh, **(rt_kw or {}))
    cut = shard_fsdp_params if rt.context_parallel else shard_params
    p = tree_map(torch.clone, cut(params, cfg, mesh, coords, device))
    rng = np.random.RandomState(0)

    def ids(*shape):
        return torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).to(
            device)
    n = {"vision": cfg.num_patches, "audio": cfg.encoder_seq_len}.get(
        cfg.frontend)
    extra = None if n is None else torch.from_numpy(
        rng.randn(batch, n, cfg.d_model).astype(np.float32) * 0.05).to(
        device)
    parallel.reset_collectives()
    with torch.no_grad():
        if mode == "prefill":
            steps.make_prefill_fn(cfg, rt)(p, None, ids(batch, seq), None,
                                           extra)
        elif mode == "decode":
            caches = M.init_decode_caches(cfg, batch, seq, rt, device=device)
            parallel.reset_collectives()
            steps.make_decode_fn(cfg, rt)(p, None, ids(batch, 1), caches,
                                          seq // 2, None)
    if mode == "train":
        state = init_sharded_train_state(p, cfg, rt)
        b = {"tokens": ids(batch, seq), "labels": ids(batch, seq),
             "mask": torch.ones((batch, seq), device=device)}
        if extra is not None:
            b["extra_embeds"] = extra
        steps.make_train_fn(cfg, rt)(state, b)
    return {"step": {k: dict(v) for k, v in parallel.COLLECTIVES.items()}}


def wrappers() -> Dict[str, Any]:
    """The six kernel wrappers, each counting its launches."""
    from repro_torch.kernels import (alora_qkv, paged_attention, ragged_lora,
                                     ssd_chunk)
    return {"ragged_paged_attention": paged_attention.ragged_paged_attention,
            "ragged_grouped_lora": ragged_lora.ragged_grouped_lora,
            "ragged_grouped_lora_qkv": ragged_lora.ragged_grouped_lora_qkv,
            "ragged_ssd_chunk_scan": ssd_chunk.ragged_ssd_chunk_scan,
            "paged_attention": paged_attention.paged_attention,
            "ssd_chunk_scan": ssd_chunk.ssd_chunk_scan,
            "alora_qkv": alora_qkv.alora_qkv}


CASES = {"model": model_case, "moe": moe_case, "cp": cp_case,
         "train": train_case, "step": step_case}


def run_cases(rank, cases: Sequence) -> Dict[str, Any]:
    """Rank entry of ``distributed.spawn.launch``: each ``(name, kind,
    args, keywords)`` runs ``CASES[kind](*args, mesh=rank.mesh,
    coords=rank.coords, device=rank.device, **keywords)``; the keyword
    ``mesh=(data, model)`` runs it on a mesh of that shape over the same
    ranks instead.  Each result gains the kernel launches and the
    collectives of its run, counted from 0."""
    from repro_torch.distributed import parallel
    from repro_torch.launch.mesh import make_host_mesh, mesh_coords
    out: Dict[str, Any] = {}
    meshes = {}
    for name, kind, args, kw in cases:
        kw = dict(kw)
        shape = kw.pop("mesh", None)
        mesh = rank.mesh
        if shape is not None:
            if shape not in meshes:
                meshes[shape] = make_host_mesh(*shape)
            mesh = meshes[shape]
        for fn in wrappers().values():
            fn.launches = 0
        parallel.reset_collectives()
        res = CASES[kind](*args, mesh=mesh, coords=mesh_coords(mesh),
                          device=rank.device, **kw)
        res["launches"] = {k: fn.launches for k, fn in wrappers().items()}
        res["collectives"] = {k: dict(v) for k, v in
                              parallel.COLLECTIVES.items()}
        out[name] = to_numpy(res)
    return out


def to_numpy(tree):
    """``tree`` with every tensor a float32 (or integer) numpy array: what
    a rank returns through the process queue."""
    from repro_torch.common import tree_map

    def conv(t):
        if not torch.is_tensor(t):
            return t
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()
    return tree_map(conv, tree)
