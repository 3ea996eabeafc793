"""The sharded mixed step's equivalence workload: the reference's
``tests/test_sharded_step.py`` traffic as functions of the port, run by
the tests on CPU ranks, by ``bench_mixed_batch --mesh`` and by the chip
smoke on ranks that share the card.

:func:`run_workload` drives any engine with the reference's surface
(this package's, sharded or not, or the reference's own): staggered
arrivals, an adapter mix cycling through three adapters on two slots
(churn), an identical-prompt pair, then a second-wave aLoRA request on
the shared prompt (cross-model prefix reuse).  :func:`run_preemption`
starves the block pool so recompute-preemption fires.
:func:`serve_cases` is the rank entry (``distributed.spawn.launch``):
one engine per case over the rank's mesh, each case's launches counted
from 0.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

# the reference test's engine: 4 running, 64 tokens a step, 2 adapter
# slots for 3 adapters
ENGINE = dict(max_running=4, max_batched_tokens=64, adapter_slots=2)
INV = (7, 8, 9)
ADAPTER_NAMES = [None, "ad0", "ad1", "ad2"]


def frames(cfg) -> Dict[str, Any]:
    """An encoder-decoder request's frame embeddings (the reference
    test's fixed draw), as ``submit`` keywords."""
    if not cfg.is_encoder_decoder:
        return {}
    return dict(frame_embeds=np.random.RandomState(77).randn(
        cfg.encoder_seq_len, cfg.d_model).astype(np.float32))


def run_workload(eng, *, n: int = 5, gen: int = 6, prompt_len: int = 40,
                 seed: int = 5) -> Tuple[List[List[int]], Dict[str, Any]]:
    """The reference test's mixed workload; returns (tokens per request,
    stats: steps with work, mixed-step calls, preemptions, reused prompt
    tokens per request, adapter evictions)."""
    cfg = eng.cfg
    rng = np.random.RandomState(seed)
    shared = list(rng.randint(10, 500, prompt_len))
    rids = []
    for i in range(n):
        prompt = shared if i < 2 else \
            list(rng.randint(10, 500, prompt_len + 8 * (i % 3)))
        rids.append(eng.submit(list(prompt), gen,
                               adapter_name=ADAPTER_NAMES[i % 4],
                               arrival_time=1e-9 * i, **frames(cfg)))
    steps = 0
    calls0 = eng.runner.call_counts["mixed_step"]
    while eng.pending or eng.waiting or eng.running:
        eng.step()
        if any(eng.last_step_tokens):
            steps += 1
    rids.append(eng.submit(list(shared), gen, adapter_name="ad1",
                           **frames(cfg)))
    while eng.pending or eng.waiting or eng.running:
        eng.step()
        if any(eng.last_step_tokens):
            steps += 1
    stats = dict(
        steps=steps,
        mixed_calls=eng.runner.call_counts["mixed_step"] - calls0,
        preemptions=eng.preemptions,
        hits=[eng.request(r).n_cache_hit_tokens for r in rids],
        evictions=eng.adapter_pool_stats().evictions)
    return [list(map(int, eng.request(r).output_tokens)) for r in rids], stats


def run_preemption(eng) -> Tuple[List[List[int]], Dict[str, Any]]:
    """Three 64-token prompts on a pool of exactly the running prompts'
    blocks (build the engine with ``num_blocks=8, max_running=2``): every
    running request hits its next block boundary in the same step with no
    block free, and the newest is preempted and recomputed."""
    rng = np.random.RandomState(11)
    prompts = [list(rng.randint(10, 500, 64)) for _ in range(3)]
    rids = [eng.submit(p, 8, adapter_name="ad1" if i == 1 else None,
                       **frames(eng.cfg))
            for i, p in enumerate(prompts)]
    eng.run_until_idle()
    return ([list(map(int, eng.request(r).output_tokens)) for r in rids],
            dict(preemptions=eng.preemptions,
                 hits=[eng.request(r).n_cache_hit_tokens for r in rids]))


def run_staggered(eng, *, lag_s: float, rank: int, gap: float = 2.0,
                  n: int = 4) -> Tuple[List[List[int]], Dict[str, Any]]:
    """Requests arriving ``gap`` virtual seconds apart on an engine whose
    clock runs fast (``EngineConfig.time_scale``), every rank but 0
    ``lag_s`` slower per step: which request a step admits depends on
    the clock, so ranks stay in step only if their clocks agree.
    Returns (tokens, stats with the clock after every step)."""
    rng = np.random.RandomState(3)
    rids = [eng.submit(list(rng.randint(10, 500, 24)), 4,
                       adapter_name=ADAPTER_NAMES[i % 4],
                       arrival_time=gap * i, **frames(eng.cfg))
            for i in range(n)]
    if rank:
        submit = eng.runner.submit_batch

        def slow(mb):
            time.sleep(lag_s)
            return submit(mb)
        eng.runner.submit_batch = slow
    clocks = []
    while eng.pending or eng.waiting or eng.running:
        eng.step()
        clocks.append(eng.clock)
    return ([list(map(int, eng.request(r).output_tokens)) for r in rids],
            dict(clocks=clocks,
                 admitted_at=[eng.request(r).t_prefill_start for r in rids]))


def sublayer_outputs(cfg, params, tp=None, seed: int = 0):
    """What layer 0's attention sublayer (whole sequences, causal: the
    encoder's path) and its MLP or MoE sublayer add to x (2, 16, d) from
    ``seed``; with ``tp`` (a rank's ``distributed.parallel.
    TensorParallel``), on the rank's slice with its collectives.  Returns
    both as float32 numpy arrays."""
    import torch

    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.models import model as M
    from repro_torch.models.layers import dtype_of
    lp, lcfg = params["layers"][0], cfg
    if tp is not None:
        lp, lcfg = shard_tree(lp, tp.layout), tp.lcfg
    x = torch.from_numpy(np.random.RandomState(seed).randn(
        2, 16, cfg.d_model).astype(np.float32)).to(dtype_of(cfg))
    pos = torch.arange(16).expand(2, 16)
    a, _ = M.attn_sublayer_full(lp, lcfg, x, pos, tp=tp)
    m = M.mlp_sublayer(lp, lcfg, x, tp=tp)
    return (a - x).float().numpy(), (m - x).float().numpy()


def leaks(eng) -> List[str]:
    """What a drained engine still holds (empty: nothing)."""
    out = []
    for name, mgr in (("kv blocks", eng.kv_mgr), ("state slots",
                                                  eng.st_mgr)):
        if mgr is not None and (mgr.num_free() != mgr.num_blocks
                                or any(m.ref for m in mgr.meta)):
            out.append(name)
    if eng.adapter_pool is not None and eng.adapter_pool.pinned_slots():
        out.append("adapter pins")
    return out


def serve_cases(rank, models: Dict[str, Tuple], cases: Sequence
                ) -> Dict[str, Any]:
    """Rank entry of ``distributed.spawn.launch``: for each case ``(name,
    arch, workload, engine keywords)`` (workload "workload",
    "preemption" or "staggered"; the keyword ``mesh=(data, model)``
    reshapes the rank's world for that case), an engine over the rank's
    mesh serves ``models[arch] = (cfg, params, [(AdapterSpec,
    weights)])`` (the full parameters or the rank's slice); the serving
    kernels' launches are counted from 0 around the run.  Returns each
    case's tokens, stats, launches, leaks and the rank's pool shapes.
    The workload "sublayers" returns :func:`sublayer_outputs` on the
    rank's slice instead (on the CPU)."""
    from repro_torch.benchmarks.common import WRAPPERS, launch_counts
    from repro_torch.distributed.parallel import TensorParallel
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import Engine, EngineConfig
    out: Dict[str, Any] = {}
    meshes = {}
    for name, arch, workload, kw in cases:
        kw = dict(kw)
        shape = kw.pop("mesh", None)
        if shape is None:
            mesh = rank.mesh
        else:
            if shape not in meshes:
                meshes[shape] = make_host_mesh(*shape)
            mesh = meshes[shape]
        cfg, params, adapters = models[arch]
        if workload == "sublayers":
            out[name] = sublayer_outputs(cfg, params,
                                         TensorParallel(cfg, mesh))
            continue
        ecfg = EngineConfig(**{**ENGINE, **kw, "mesh": mesh})
        eng = Engine(cfg, params, adapters=list(adapters), engine_cfg=ecfg,
                     device=rank.device)
        for fn in WRAPPERS.values():
            fn.launches = 0
        if workload == "workload":
            toks, st = run_workload(eng)
        elif workload == "preemption":
            toks, st = run_preemption(eng)
        else:
            toks, st = run_staggered(eng, lag_s=0.02, rank=rank.rank)
        r = eng.runner
        out[name] = dict(
            tokens=toks, stats=st, launches=launch_counts(),
            leaks=leaks(eng), k_pool=None if r.k_pool is None
            else tuple(r.k_pool.shape),
            live_ssm=None if r.live_ssm is None else tuple(r.live_ssm.shape),
            tok_bucket_lo=r._tok_bucket_lo,
            d2h=sorted({(d, tag) for _, d, tag in r.d2h_fetches}),
            call_counts=dict(r.call_counts))
    return out
