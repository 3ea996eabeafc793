"""The port's multi-replica router (``repro_torch.serving.router``)
against the reference's ``repro.serving.router.Router`` on the reduced
granite with converted weights and two replicas, on the shape of the
reference's ``tests/test_router.py::run_trace``, with and without
sticky sessions, under ``affinity`` and ``round_robin``: the placements
log, the tokens of every router-global id, the fleet ``kv_hit_rate``
and, after ``stop_replica``, the re-routed count are identical.  Also:
the engine's placement probes are non-acquiring and equal the
reference's, ``idle`` stays False while an async step is in flight, the
fleet's adapter uids agree, and a reduced mamba2 fleet of the port
equals the port's single engine (state snapshots; B3's plain version).
"""
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
from repro.serving.router import Router as JRouter
from repro_torch.configs import get_reduced
from repro_torch.core.alora import AdapterSpec, init_adapter_weights
from repro_torch.models.convert import adapters_from_jax, params_from_jax
from repro_torch.models.model import init_params
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.router import POLICIES, Placement, Router

# one intra-op thread: this file shares the CPU with the rest of the suite
torch.set_num_threads(1)

INV = (7, 8, 9)
ENGINE = dict(max_running=4, max_batched_tokens=64, adapter_slots=2)


def scaled(tree, scale=30.0):
    """The reference router tests' adapters: B scaled up so that the
    adapters change the tokens."""
    return {seg: {k: (v * scale if k.startswith("b") else v)
                  for k, v in leaves.items()} for seg, leaves in tree.items()}


@pytest.fixture(scope="module")
def granite():
    cfg_j = jax_reduced("granite-3.2-8b")
    cfg = get_reduced("granite-3.2-8b")
    pj = jax_init(jax.random.key(0), cfg_j)
    ads = [scaled(jax_adapter(jax.random.key(100 + i), cfg_j, 8))
           for i in range(4)]
    specs = [(f"ad{i}", INV if i % 2 else None) for i in range(3)]
    return dict(
        cfg_j=cfg_j, cfg=cfg, pj=pj, ads=ads, specs=specs,
        params=params_from_jax(jax.tree.map(np.asarray, pj), cfg, "cpu"),
        tads=[adapters_from_jax(jax.tree.map(np.asarray, a), cfg, "cpu")
              for a in ads])


def routers(w, n, policy="affinity", **kw):
    """The reference's and the port's n-replica router, each replica
    built alike (the same adapters in the same order)."""
    ecfg = dict(ENGINE, **kw)
    ref = JRouter([JEngine(w["cfg_j"], w["pj"], engine_cfg=JConfig(**ecfg),
                           adapters=[(JSpec(n_, 8, inv), w["ads"][i])
                                     for i, (n_, inv) in
                                     enumerate(w["specs"])])
                   for _ in range(n)], policy=policy)
    port = Router([Engine(w["cfg"], w["params"], device="cpu",
                          engine_cfg=EngineConfig(**ecfg),
                          adapters=[(AdapterSpec(n_, 8, inv), w["tads"][i])
                                    for i, (n_, inv) in
                                    enumerate(w["specs"])])
                   for _ in range(n)], policy=policy)
    return ref, port


def run_trace(router, cfg, *, sessions=5, turns=2, gen=5, seed=3,
              use_sessions=False, prompt_len=24):
    """``tests/test_router.py::run_trace``: turn k+1 extends turn k's
    prompt + generated tokens, alternating base and adapter turns.
    Returns router-global ids in submit order."""
    rng = np.random.RandomState(seed)
    hi = min(400, cfg.vocab_size)
    convo = [list(rng.randint(10, hi, prompt_len + 4 * (s % 3)))
             for s in range(sessions)]
    gids = []
    for t in range(turns):
        round_ids = []
        for s in range(sessions):
            adapter = f"ad{s % 2}" if t % 2 else None
            kw = dict(session=s) if use_sessions else {}
            round_ids.append(router.submit(convo[s], gen,
                                           adapter_name=adapter, **kw))
        router.run_until_idle()
        for s, gid in enumerate(round_ids):
            out = router.request(gid).output_tokens
            assert len(out) == gen
            convo[s] = convo[s] + list(out) \
                + list(rng.randint(10, hi, 12))
        gids.extend(round_ids)
    return gids


def assert_same_fleet(port, ref, gids):
    assert port.placements == [Placement(**vars(p)) for p in ref.placements]
    for gid in gids:
        assert port.request(gid).output_tokens == \
            ref.request(gid).output_tokens, gid
        assert port.request(gid).n_cache_hit_tokens == \
            ref.request(gid).n_cache_hit_tokens, gid
        assert port.replica_of(gid) == ref.replica_of(gid)
    assert port.kv_hit_rate() == ref.kv_hit_rate()
    assert [(e.kv_mgr.hits, e.kv_mgr.misses) for e in port.replicas] == \
        [(e.kv_mgr.hits, e.kv_mgr.misses) for e in ref.replicas]
    assert port.reroutes == ref.reroutes
    assert port.tracer.counters == ref.tracer.counters


@pytest.mark.parametrize("use_sessions", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_router_matches_reference(granite, policy, use_sessions):
    ref, port = routers(granite, 2, policy)
    gids = run_trace(ref, granite["cfg_j"], use_sessions=use_sessions)
    assert run_trace(port, granite["cfg"],
                     use_sessions=use_sessions) == gids
    assert_same_fleet(port, ref, gids)
    assert len({p.replica for p in port.placements}) == 2
    fleet = port.metrics_for(gids)
    per = port.per_replica_metrics(gids)
    assert fleet.n == sum(p.n for p in per.values()) == len(gids)
    assert fleet.total_tokens == sum(p.total_tokens for p in per.values())
    if use_sessions:
        # every later turn follows its session's pin
        by_session = {}
        for p in port.placements:
            by_session.setdefault(p.req_id % 5, []).append(p)
        for places in by_session.values():
            assert len({p.replica for p in places}) == 1
            assert [p.via_session for p in places] == [False, True]


def test_affinity_beats_round_robin(granite):
    """On the multi-turn trace affinity keeps each session's later turns
    where its blocks live, so its fleet hit rate is above round
    robin's."""
    rates = {}
    for policy in POLICIES:
        _, port = routers(granite, 2, policy)
        run_trace(port, granite["cfg"], turns=3)
        rates[policy] = port.kv_hit_rate()
    assert rates["affinity"] > rates["round_robin"]


def test_drain_matches_reference(granite):
    """``stop_replica`` mid-flight re-routes the victim's queued requests
    and drains its admitted ones, exactly as the reference's router does,
    and every request still reaches full length."""
    ref, port = routers(granite, 2)
    gen = 5
    runs = []
    for router in (ref, port):
        rng = np.random.RandomState(9)
        gids = [router.submit(list(rng.randint(10, 400, 32 + i)), gen,
                              adapter_name=[None, "ad0", "ad1"][i % 3])
                for i in range(12)]
        for _ in range(2):
            router.step()
        moved = router.stop_replica(0)
        assert router.stop_replica(0) == 0
        with pytest.raises(RuntimeError):
            router.stop_replica(1)
        gids.append(router.submit(list(rng.randint(10, 400, 30)), gen))
        router.run_until_idle()
        runs.append((gids, moved))
    (gids, moved), (pgids, pmoved) = runs
    assert pgids == gids and pmoved == moved > 0
    assert port.reroutes == moved
    assert_same_fleet(port, ref, gids)
    assert all(len(port.request(g).output_tokens) == gen for g in gids)
    assert port.replica_of(gids[-1]) == 1
    assert port.replicas[0].idle


def test_probes_are_non_acquiring_and_match_reference(granite):
    """The six probes read scheduler state only: the prefix cache's hit,
    miss and eviction counters, every refcount and the free list are as
    they were; each probe's value equals the reference engine's in the
    same state (a base prompt, an aLoRA prompt with and without its
    invocation tokens, a vanilla-LoRA prompt, an unknown adapter)."""
    ref, port = routers(granite, 1)
    rng = np.random.RandomState(6)
    prompt = list(rng.randint(10, 400, 40))
    for router in (ref, port):
        router.submit(list(prompt), 5)
        router.submit(list(rng.randint(10, 400, 37)), 5, adapter_name="ad0")
        router.step()                   # the second request in flight
    probes = [(prompt + [1, 2, 3], None), (prompt + [1, 2, 3], "ad1"),
              (prompt + list(INV) + [5], "ad1"), (prompt, "ad0"),
              (prompt[:17], None)]
    values = []
    for router in (ref, port):
        eng = router.replicas[0]
        mgr = eng.kv_mgr
        before = (mgr.hits, mgr.misses, mgr.evictions,
                  [m.ref for m in mgr.meta], list(mgr.free),
                  dict(mgr.index))
        values.append((
            [eng.cached_prefix_tokens(p, a) for p, a in probes],
            eng.outstanding_tokens(), eng.idle, eng.adapter_residency(),
            [eng.adapter_affinity(n) for n in ("ad0", "ad1", "nope")],
            eng.kv_hit_rate(), eng.cache.hit_rate(),
            [eng.request(i).seq_len for i in (0, 1)]))
        assert (mgr.hits, mgr.misses, mgr.evictions,
                [m.ref for m in mgr.meta], list(mgr.free),
                dict(mgr.index)) == before
    want, got = values
    assert got == want
    depths = got[0]
    assert depths[0] > 0 and depths[1] == depths[0] and depths[3] == 0
    assert got[2] is False
    mgr = port.replicas[0].kv_mgr
    mgr.reset_stats()
    assert (mgr.hits, mgr.misses, mgr.evictions, mgr.hit_rate()) == \
        (0, 0, 0, 0.0)
    pool, jpool = port.replicas[0].adapter_pool, ref.replicas[0].adapter_pool
    assert pool.pinned_slots() == jpool.pinned_slots() == 1
    assert pool.residency() == jpool.residency()
    assert pool.affinity("ad0") == 2 and pool.affinity("nope") == 0
    with pytest.raises(KeyError):
        port.replicas[0].cached_prefix_tokens(prompt, "nope")


def test_idle_is_false_while_a_step_is_in_flight(granite):
    """With async submission every request of the step in flight stays
    in ``running`` until the step retires, so ``idle`` cannot report a
    drained engine while the card still holds its work."""
    _, port = routers(granite, 1)
    eng = port.replicas[0]
    rng = np.random.RandomState(2)
    for i in range(3):
        eng.submit(list(rng.randint(10, 400, 20 + 7 * i)), 3 + i)
    inflight_steps = 0
    while not eng.idle:
        eng.step()
        inf = eng._inflight
        if inf is not None:
            inflight_steps += 1
            assert not eng.idle
            for r, epoch, *_ in inf.retires:
                assert r.epoch != epoch or r in eng.running
    assert inflight_steps > 0 and eng._inflight is None
    assert eng.kv_mgr.num_free() == eng.kv_mgr.num_blocks


def test_fleet_adapter_uids_agree(granite):
    """Registration through the router gives one uid on every replica,
    the reference's; it is served, resident where it ran, and
    unregistered everywhere."""
    ref, port = routers(granite, 2)
    cfg = granite["cfg"]
    uid = port.register_adapter(AdapterSpec("late", 8), granite["tads"][3])
    assert uid == ref.register_adapter(JSpec("late", 8), granite["ads"][3])
    assert uid == "late#v1"
    gid = port.submit(list(range(10, 40)), 4, adapter_name="late")
    port.run_until_idle()
    assert len(port.request(gid).output_tokens) == 4
    idx = port.replica_of(gid)
    assert port.replicas[idx].adapter_residency()["late"] is True
    assert port.replicas[1 - idx].adapter_residency()["late"] is False
    port.unregister_adapter("late")
    assert all("late" not in e.adapter_residency() for e in port.replicas)
    # a re-registration bumps the version on every replica alike
    assert port.register_adapter(
        AdapterSpec("late", 8), init_adapter_weights(
            torch.Generator().manual_seed(0), cfg, 8,
            device="cpu")) == "late#v2"


def test_stop_replica_drops_unclaimed_stages(granite):
    _, port = routers(granite, 2)
    pool = port.replicas[0].adapter_pool
    uid = pool.uid_of("ad1")
    assert pool.prefetch(uid) and pool.staged_now == 1
    port.stop_replica(0)
    assert pool.staged_now == 0 and pool.get(uid).device_layers is None
    assert port.replicas[1].adapter_pool.staged_now == 0


def test_construction_validation(granite):
    with pytest.raises(ValueError):
        Router([])
    _, port = routers(granite, 1)
    with pytest.raises(ValueError):
        Router(port.replicas, policy="sticky-dice")
    assert port.cfg is port.replicas[0].cfg
    assert set(port.adapters) == {"ad0", "ad1", "ad2"}


def test_mamba2_fleet_matches_single_engine():
    """A reduced mamba2 fleet of the port (state snapshots, B3's plain
    version) emits the single engine's tokens for every global id."""
    cfg = get_reduced("mamba2-2.7b")
    gen = torch.Generator().manual_seed(0)
    params = init_params(gen, cfg, device="cpu")
    ads = [(AdapterSpec(f"ad{i}", 8, INV if i % 2 else None),
            init_adapter_weights(gen, cfg, 8, device="cpu"))
           for i in range(2)]

    def fleet(n):
        return Router([Engine(cfg, params, device="cpu", adapters=ads,
                              engine_cfg=EngineConfig(**ENGINE))
                       for _ in range(n)])
    one, two = fleet(1), fleet(2)
    gids = run_trace(one, cfg, sessions=3)
    assert run_trace(two, cfg, sessions=3) == gids
    for gid in gids:
        assert two.request(gid).output_tokens == \
            one.request(gid).output_tokens, gid
    assert len({p.replica for p in two.placements}) == 2
    assert sum(e.st_mgr.hits for e in two.replicas) > 0
    assert any(two.request(g).state_reused for g in gids)
