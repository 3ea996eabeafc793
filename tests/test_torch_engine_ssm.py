"""The port's engine against ``repro.serving.Engine`` on reduced mamba2
(pure SSM) and zamba2 (hybrid) with converted weights, through the
paper's base → aLoRA pipeline: identical output tokens for every
request, equal state-snapshot hits (``st_mgr``) and KV hits
(``kv_mgr``, hybrid only), equal ``n_cache_hit_tokens`` and
``state_reused``, with async submission on and off — and nothing leaked
after the drain.  Then, on the port alone, the state-reuse check of the
reference's ``test_ssm_state_reuse_exact``: with the prefix cache on the
eval request restores a snapshot and reuses tokens, and emits the same
tokens as with the cache off."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core.alora import AdapterSpec as JSpec
from repro.core.alora import init_adapter_weights as jax_adapter
from repro.models import init_params as jax_init
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JConfig
from repro.serving import pipelines as JP
from repro_torch.configs import get_reduced
from repro_torch.core.alora import AdapterSpec
from repro_torch.models.convert import adapters_from_jax, params_from_jax
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving import pipelines as P

# one intra-op thread: this file shares the CPU with the rest of the suite
torch.set_num_threads(1)

INV = (7, 8, 9)
ARCHS = ["mamba2-2.7b", "zamba2-2.7b"]
PIPE = dict(prompt_len=32, gen_len=4, eval_len=2, batch=2)


@functools.lru_cache(maxsize=None)
def _weights(name):
    cfg_j = jax_reduced(name)
    cfg = get_reduced(name)
    pj = jax_init(jax.random.key(0), cfg_j)
    aj = jax_adapter(jax.random.key(7), cfg_j, 8)
    return dict(
        cfg_j=cfg_j, cfg=cfg, pj=pj, aj=aj,
        params=params_from_jax(jax.tree.map(np.asarray, pj), cfg, "cpu"),
        ad=adapters_from_jax(jax.tree.map(np.asarray, aj), cfg, "cpu"),
        ref={})


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return _weights(request.param)


def _ref_run(a, async_on):
    """The reference engine's run, computed once per mode."""
    if async_on not in a["ref"]:
        eng = JEngine(a["cfg_j"], a["pj"],
                      engine_cfg=JConfig(async_submission=async_on),
                      adapters=[(JSpec("uq", 8, INV), a["aj"])])
        res = JP.base_adapter(eng, adapter_names=["uq"], **PIPE)
        a["ref"][async_on] = (eng, res)
    return a["ref"][async_on]


def _port(a, **ecfg):
    return Engine(a["cfg"], a["params"], device="cpu",
                  engine_cfg=EngineConfig(**ecfg),
                  adapters=[(AdapterSpec("uq", 8, INV), a["ad"])])


@pytest.mark.parametrize("async_on", [True, False], ids=["async", "sync"])
def test_engine_matches_reference(arch, async_on):
    jeng, jres = _ref_run(arch, async_on)
    eng = _port(arch, async_submission=async_on)
    res = P.base_adapter(eng, adapter_names=["uq"], **PIPE)
    ids = res.base_ids + res.eval_ids
    assert ids == jres.base_ids + jres.eval_ids
    for rid in ids:
        got, want = eng.request(rid), jeng.request(rid)
        assert got.output_tokens == want.output_tokens, rid
        assert got.n_cache_hit_tokens == want.n_cache_hit_tokens, rid
        assert got.state_reused == want.state_reused, rid
    for rid in res.eval_ids:                   # cross-model state reuse
        assert eng.request(rid).state_reused
        assert eng.request(rid).n_cache_hit_tokens >= 32
    for mgr, jmgr in ((eng.st_mgr, jeng.st_mgr), (eng.kv_mgr, jeng.kv_mgr)):
        assert (mgr is None) == (jmgr is None)
        if mgr is None:
            continue
        assert (mgr.hits, mgr.misses, mgr.evictions) == \
            (jmgr.hits, jmgr.misses, jmgr.evictions)
        assert sum(m.ref for m in mgr.meta) == 0          # nothing leaked
        assert mgr.num_free() == mgr.num_blocks
    assert eng.st_mgr.hits == len(res.eval_ids)
    assert (eng.kv_mgr is None) == (arch["cfg"].name.startswith("mamba2"))
    assert eng.runner.call_counts["mixed_step"] == \
        jeng.runner.call_counts["mixed_step"]


def test_state_reuse_is_exact(arch):
    """Cache on restores the base request's state snapshot and gives the
    same tokens as cache off, which recomputes the whole prompt."""
    outs, hits = [], []
    x = list(np.random.RandomState(1).randint(10, arch["cfg"].vocab_size,
                                              96))
    for cache_on in (True, False):
        eng = _port(arch, enable_prefix_cache=cache_on)
        r1 = eng.submit(x, 8)
        eng.run_until_idle()
        y = eng.request(r1).output_tokens
        r2 = eng.submit(x + y + list(INV), 4, adapter_name="uq")
        eng.run_until_idle()
        req = eng.request(r2)
        outs.append(req.output_tokens)
        hits.append((req.n_cache_hit_tokens, req.state_reused))
    assert outs[0] == outs[1]
    assert hits[0][0] > 0 and hits[0][1]
    assert hits[1] == (0, False)


@pytest.mark.parametrize("async_on", [True, False], ids=["async", "sync"])
def test_zamba2_under_block_pressure(async_on):
    """The hybrid under block and state-slot pressure (8 blocks of 16, 6
    snapshot slots, two running, three 64-token requests, base and aLoRA):
    recompute-preemption runs through ``_preempt`` and the finishes
    through ``_finish_requests``; tokens, reused tokens, preemptions and
    both pools' counters equal the reference's, and nothing leaks."""
    a = _weights("zamba2-2.7b")
    kw = dict(num_blocks=8, num_state_slots=6, max_running=2,
              async_submission=async_on)
    rng = np.random.RandomState(4)
    prompts = [list(rng.randint(10, a["cfg"].vocab_size, 61)) + list(INV)
               for _ in range(3)]
    jeng = JEngine(a["cfg_j"], a["pj"], engine_cfg=JConfig(**kw),
                   adapters=[(JSpec("uq", 8, INV), a["aj"])])
    eng = _port(a, **kw)
    runs = []
    for e in (jeng, eng):
        rids = [e.submit(p, 4, adapter_name="uq" if i % 2 else None)
                for i, p in enumerate(prompts)]
        e.run_until_idle()
        runs.append(([e.request(r).output_tokens for r in rids],
                     [e.request(r).n_cache_hit_tokens for r in rids],
                     e.preemptions,
                     [(m.hits, m.misses, m.evictions)
                      for m in (e.kv_mgr, e.st_mgr)]))
    assert runs[0] == runs[1]
    assert eng.preemptions > 0
    for mgr in (eng.kv_mgr, eng.st_mgr):
        assert sum(m.ref for m in mgr.meta) == 0
        assert mgr.num_free() == mgr.num_blocks
    assert sorted(eng._free_slots) == [0, 1]
    assert eng.adapter_pool.pinned_slots() == 0
