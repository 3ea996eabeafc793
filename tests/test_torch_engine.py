"""The port's engine against ``repro.serving.Engine`` on the reduced
granite with converted weights, through the paper's base → adapter
pipeline: identical output tokens for every request, equal
``BlockManager.hits`` and per-request ``n_cache_hit_tokens``, with async
submission on and off, under adapter churn through a one-slot pool, and
under block pressure with preemption — and no block leaked after the
drain."""
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
# name -> (engine config, adapters as (name, rank, invocation), pipeline)
CASES = {
    "async": (dict(), [("uq", 8, INV)],
              dict(prompt_len=40, gen_len=6, eval_len=4, batch=2)),
    "sync": (dict(async_submission=False), [("uq", 8, INV)],
             dict(prompt_len=40, gen_len=6, eval_len=4, batch=2)),
    "churn": (dict(adapter_slots=1), [("uq", 8, INV), ("lo", 8, None)],
              dict(prompt_len=36, gen_len=5, eval_len=3, batch=2)),
    "pressure": (dict(num_blocks=8, max_running=3, max_batched_tokens=32,
                      admission_policy="fcfs"), [("uq", 8, INV)],
                 dict(prompt_len=30, gen_len=20, eval_len=4, batch=3)),
}


@pytest.fixture(scope="module")
def weights():
    cfg_j = jax_reduced("granite-3.2-8b")
    cfg = get_reduced("granite-3.2-8b")
    pj = jax_init(jax.random.key(0), cfg_j)
    ads = {r: jax_adapter(jax.random.key(10 + r), cfg_j, 8) for r in (0, 1)}
    return dict(cfg_j=cfg_j, cfg=cfg, pj=pj, ads=ads,
                params=params_from_jax(jax.tree.map(np.asarray, pj), cfg,
                                       "cpu"),
                tads={r: adapters_from_jax(jax.tree.map(np.asarray, a), cfg,
                                           "cpu") for r, a in ads.items()})


@pytest.fixture(scope="module")
def reference_runs(weights):
    """The reference engine's run of each case, computed once."""
    cache = {}

    def run(name):
        if name not in cache:
            ecfg, ads, pipe = CASES[name]
            eng = JEngine(weights["cfg_j"], weights["pj"],
                          engine_cfg=JConfig(**ecfg),
                          adapters=[(JSpec(n, r, inv), weights["ads"][i])
                                    for i, (n, r, inv) in enumerate(ads)])
            res = JP.base_adapter(eng, adapter_names=[a[0] for a in ads],
                                  **pipe)
            cache[name] = (eng, res)
        return cache[name]
    return run


@pytest.mark.parametrize("name", list(CASES))
def test_engine_matches_reference(weights, reference_runs, name):
    ecfg, ads, pipe = CASES[name]
    jeng, jres = reference_runs(name)
    eng = Engine(weights["cfg"], weights["params"], device="cpu",
                 engine_cfg=EngineConfig(**ecfg),
                 adapters=[(AdapterSpec(n, r, inv), weights["tads"][i])
                           for i, (n, r, inv) in enumerate(ads)])
    res = P.base_adapter(eng, adapter_names=[a[0] for a in ads], **pipe)
    ids = res.base_ids + res.eval_ids
    assert ids == jres.base_ids + jres.eval_ids
    for rid in ids:
        got, want = eng.request(rid), jeng.request(rid)
        assert got.output_tokens == want.output_tokens, rid
        assert got.n_cache_hit_tokens == want.n_cache_hit_tokens, rid
    assert eng.kv_mgr.hits == jeng.kv_mgr.hits
    assert eng.kv_mgr.evictions == jeng.kv_mgr.evictions
    assert eng.kv_mgr.misses == jeng.kv_mgr.misses
    assert eng.preemptions == jeng.preemptions
    assert eng.runner.call_counts["mixed_step"] == \
        jeng.runner.call_counts["mixed_step"]
    # leak check after the drain
    assert sum(m.ref for m in eng.kv_mgr.meta) == 0
    assert eng.kv_mgr.num_free() == eng.kv_mgr.num_blocks
    assert all(eng.adapter_pool.get(eng.adapter_pool.uid_of(a[0])).pins == 0
               for a in ads)
    if name == "churn":
        st, jst = eng.adapter_pool_stats(), jeng.adapter_pool_stats()
        assert st.evictions == jst.evictions > 0
        assert st.installs == jst.installs
    if name == "pressure":
        assert eng.preemptions > 0           # the pool really ran short
    else:
        assert eng.kv_mgr.hits > 0           # eval requests reused blocks


def test_adapter_registry_and_staging_tier(weights):
    """Registration at any time, versioned uids, the staging tier's TTL
    and drain, refusal to unregister a live adapter, and the rank check."""
    from repro_torch.core.alora import pad_adapter_rank
    eng = Engine(weights["cfg"], weights["params"], device="cpu",
                 engine_cfg=EngineConfig(adapter_slots=1,
                                         adapter_staging_ttl=2))
    pool = eng.adapter_pool
    uid = eng.register_adapter(AdapterSpec("a", 8, INV), weights["tads"][0])
    assert uid == "a#v1" and pool.affinity_of(uid) == 0
    assert pool.prefetch(uid) and pool.staged_now == 1
    assert pool.affinity_of(uid) == 1
    for _ in range(3):
        pool.tick()
    assert pool.staged_now == 0 and pool.stats().staged_dropped == 1
    pool.prefetch(uid)
    assert pool.drop_unclaimed_stages() == 1
    rid = eng.submit(list(range(10, 40)) + list(INV), 3, adapter_name="a")
    with pytest.raises(RuntimeError, match="still referenced"):
        eng.unregister_adapter("a")
    eng.run_until_idle()
    assert len(eng.request(rid).output_tokens) == 3
    assert pool.affinity_of(uid) == 2 and pool.stats().installs == 1
    eng.unregister_adapter("a")
    assert eng.register_adapter(AdapterSpec("a", 8, INV),
                                weights["tads"][1]) == "a#v2"
    with pytest.raises(ValueError, match="rank"):
        eng.register_adapter(AdapterSpec("big", 16, None),
                             pad_adapter_rank(weights["tads"][0], 16))
