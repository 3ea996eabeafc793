"""The port's sharded mixed step (``EngineConfig.mesh``) on CPU ranks
against the reference's single-device engine.

Ranks are processes of one gloo group (``distributed.spawn.launch``);
each runs the port's engine, and imports no JAX, over reduced models
with the port's weights from a seed.  The oracle is
``repro.serving.Engine`` in this process on the same weights (carried
over by ``convert.params_to_jax``) and the
reference test's workload (``tests/test_sharded_step.py``: staggered
arrivals, three adapters on two slots, an identical-prompt pair, a
second-wave aLoRA request on the shared prompt; recompute-preemption on
a starved pool).  Tokens are exact (float32); reused prompt tokens,
adapter evictions and work steps are equal, with one mixed-step call per
work step, nothing leaked, and every rank holding the same tokens.

Two worlds run every case, started once in the background while the
oracle computes: two ranks for ``(data=1, model=2)``, four ranks for
``(data=2, model=2)`` (token-sharded, and with ``data_shard_tokens``
off) and ``(data=1, model=4)`` (granite's two K/V heads replicated over
four ranks)."""
import concurrent.futures
import functools
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core.alora import AdapterSpec as JSpec
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JConfig
from repro_torch.benchmarks import sharded_step as S
from repro_torch.configs import get_reduced
from repro_torch.core.alora import AdapterSpec, init_adapter_weights
from repro_torch.distributed.spawn import RankError, launch
from repro_torch.models.convert import params_to_jax
from repro_torch.models.model import init_params
from repro_torch.serving import Engine, EngineConfig

torch.set_num_threads(1)

ARCHS = ["granite-3.2-8b", "mamba2-2.7b", "whisper-large-v3"]
# layer 0's attention and MLP/MoE sublayers on each rank's slice
SUBLAYER_ARCHS = ["granite-3.2-8b", "granite-moe-1b-a400m",
                  "phi3.5-moe-42b-a6.6b", "whisper-large-v3"]
PREEMPT = dict(num_blocks=8, max_running=2)


def scaled_adapter(cfg, seed):
    """The reference test's adapter: B amplified so adapted tokens
    diverge from the base model's."""
    w = init_adapter_weights(torch.Generator().manual_seed(seed), cfg, 8,
                             device="cpu")
    return {seg: {k: (v * 30.0 if k.startswith("b") else v)
                  for k, v in leaves.items()} for seg, leaves in w.items()}


@functools.lru_cache(maxsize=None)
def zoo(arch):
    """(reference cfg, params, adapters), (port cfg, params, adapters):
    the port's weights from a seed, carried to the reference
    (``convert.params_to_jax`` copies)."""
    cfg_j, cfg = jax_reduced(arch), get_reduced(arch)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ads = [(f"ad{i}", S.INV if i % 2 else None, scaled_adapter(cfg, 100 + i))
           for i in range(3)]
    to_jax = functools.partial(jax.tree.map, lambda a: jax.numpy.asarray(
        np.array(a)))
    ref = (cfg_j, to_jax(params_to_jax(params, cfg)),
           [(JSpec(n, 8, inv), to_jax({s: {k: v.numpy() for k, v in l.items()}
                                      for s, l in w.items()}))
            for n, inv, w in ads])
    port = (cfg, params, [(AdapterSpec(n, 8, inv), w) for n, inv, w in ads])
    return ref, port


# world → (data, model, cases (name, arch, workload, engine keywords))
WORLDS = {
    "2": (1, 2, [(f"{a}@1x2", a, "workload", {}) for a in ARCHS]
          + [("clock", "granite-3.2-8b", "staggered",
              dict(time_scale=1e3))]
          + [(f"{a}/sublayers@1x2", a, "sublayers", {})
             for a in SUBLAYER_ARCHS]),
    "4": (2, 2, [(f"{a}@2x2", a, "workload", {}) for a in ARCHS]
          + [(f"{a}@2x2-off", a, "workload", dict(data_shard_tokens=False))
             for a in ARCHS]
          + [("preemption@2x2", "granite-3.2-8b", "preemption", PREEMPT),
             ("granite-3.2-8b@1x4", "granite-3.2-8b", "workload",
              dict(mesh=(1, 4)))]),
}


@pytest.fixture(scope="module")
def ranks():
    """Each world's per-rank results, run in background threads (the
    ranks are processes) while the tests compute the oracle."""
    models = {a: zoo(a)[1] for a in ARCHS + SUBLAYER_ARCHS}
    out, threads = {}, []

    def run(name, data, model, cases):
        try:
            out[name] = launch(S.serve_cases, models, cases, data=data,
                               model=model, device="cpu", timeout=300)
        except Exception as e:          # reported by the test that reads it
            out[name] = e

    for name, (data, model, cases) in WORLDS.items():
        threads.append(threading.Thread(target=run, args=(name, data, model,
                                                          cases)))
        threads[-1].start()

    def get(case):
        world = next(w for w, (_, _, cases) in WORLDS.items()
                     if any(c[0] == case for c in cases))
        threads[list(WORLDS).index(world)].join(timeout=600)
        res = out[world]
        if isinstance(res, Exception):
            raise res
        return [r[case] for r in res]
    yield get
    for t in threads:
        t.join(timeout=600)


def _oracle(arch, workload):
    cfg, params, ads = zoo(arch)[0]
    kw = PREEMPT if workload == "preemption" else {}
    eng = JEngine(cfg, params, adapters=ads,
                  engine_cfg=JConfig(**{**S.ENGINE, **kw}))
    return (S.run_preemption if workload == "preemption"
            else S.run_workload)(eng)


ORACLES = [(a, "workload") for a in ARCHS] + [("granite-3.2-8b",
                                               "preemption")]


@pytest.fixture(scope="module")
def oracle():
    """The reference engine's runs, each in its own thread (most of their
    time is XLA compiling, which leaves the interpreter free)."""
    for a in ARCHS:
        zoo(a)
    with concurrent.futures.ThreadPoolExecutor(len(ORACLES)) as pool:
        futs = {key: pool.submit(_oracle, *key) for key in ORACLES}
        runs = {key: f.result() for key, f in futs.items()}
    return lambda arch, workload: runs[(arch, workload)]


def same_on_every_rank(res):
    for r in res[1:]:
        assert r["tokens"] == res[0]["tokens"]
        assert r["stats"] == res[0]["stats"]


def check_rank(r):
    assert r["leaks"] == []
    # the sampled ids are the only per-step fetch, and they are int32
    assert [d for d, tag in r["d2h"] if tag == "step"] == ["int32"]
    assert r["call_counts"]["prefill_chunk"] == 0
    assert r["call_counts"]["decode_batch"] == 0


@pytest.mark.parametrize("case", [f"{a}@{m}" for m in ("1x2", "2x2")
                                  for a in ARCHS] + ["granite-3.2-8b@1x4"])
def test_sharded_matches_reference(ranks, oracle, case):
    """The sharded engine ≡ the reference's single-device engine: tokens,
    reused prompt tokens (the second-wave aLoRA request reuses the base
    request's blocks), evictions (3 adapters churn through 2 slots), work
    steps, one mixed-step call per work step."""
    want_toks, want = oracle(case.split("@")[0], "workload")
    res = ranks(case)
    same_on_every_rank(res)
    for r in res:
        check_rank(r)
    toks, st = res[0]["tokens"], res[0]["stats"]
    assert toks == want_toks and all(toks)
    assert st["hits"] == want["hits"] and st["hits"][-1] > 0
    assert st["evictions"] == want["evictions"] > 0
    assert st["steps"] == want["steps"]
    assert st["mixed_calls"] == st["steps"]


@pytest.mark.parametrize("arch", ARCHS)
def test_data_shard_off_matches_on(ranks, arch):
    """Token sharding is a layout change: ``data_shard_tokens=False``
    (every data rank computes the whole batch) ≡ the token-sharded
    default, token for token, with the same schedule; the token buckets
    start at the data axis only when sharding."""
    on, off = ranks(f"{arch}@2x2"), ranks(f"{arch}@2x2-off")
    same_on_every_rank(off)
    assert off[0]["tokens"] == on[0]["tokens"]
    assert off[0]["stats"] == on[0]["stats"]
    assert [r["tok_bucket_lo"] for r in on] == [2] * 4
    assert [r["tok_bucket_lo"] for r in off] == [1] * 4
    assert ranks(f"{arch}@1x2")[0]["tok_bucket_lo"] == 1


def test_rank_pools_hold_their_heads(ranks):
    """Each rank's pools hold its slice: granite (8 query, 2 K/V heads)
    keeps 1 K/V head per rank at model=2 and model=4 (replicated over
    two ranks there), mamba2 4 of its 8 SSM heads, whisper 2 of 4."""
    assert ranks("granite-3.2-8b@1x2")[0]["k_pool"][3] == 1
    assert ranks("granite-3.2-8b@1x4")[0]["k_pool"][3] == 1
    assert ranks("mamba2-2.7b@2x2")[0]["live_ssm"][2] == 4
    assert ranks("whisper-large-v3@1x2")[0]["k_pool"][3] == 2


def test_preemption_recompute_equivalence(ranks, oracle):
    """Block starvation preempts at the same step on the sharded engine
    and the re-prefill reproduces the reference's tokens."""
    want_toks, want = oracle("granite-3.2-8b", "preemption")
    res = ranks("preemption@2x2")
    same_on_every_rank(res)
    assert want["preemptions"] > 0
    assert res[0]["stats"]["preemptions"] == want["preemptions"]
    assert res[0]["tokens"] == want_toks
    assert res[0]["leaks"] == []


def test_clock_follows_rank_zero(ranks):
    """With the clock 1000× wall time and rank 1 slower per step, every
    rank still admits the same requests at the same steps: the clock
    advances by rank 0's measurement on all of them."""
    res = ranks("clock")
    same_on_every_rank(res)
    assert all(len(t) == 4 for t in res[0]["tokens"])


@pytest.mark.parametrize("arch", SUBLAYER_ARCHS)
def test_sublayers_within_tolerance(ranks, arch):
    """What layer 0's attention and MLP/MoE sublayers add to the hidden
    state, on each of two ranks (the MoE's experts split 2 + 2, their
    float32 sum reordered), within 1e-5 of the max of the unsharded
    port's, itself held to the reference in ``test_torch_layers.py`` and
    ``test_torch_moe.py``."""
    cfg, params, _ = zoo(arch)[1]
    want = S.sublayer_outputs(cfg, params)
    for got in ranks(f"{arch}/sublayers@1x2"):
        for g, w in zip(got, want):
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


def test_rank_failure_raises():
    """A rank's exception fails the launch, with the rank's traceback;
    ranks default to the card and raise without one."""
    with pytest.raises(RankError, match="KeyError: 'no-such-arch'"):
        launch(S.serve_cases, {}, [("x", "no-such-arch", "workload", {})],
               data=1, model=2, device="cpu", timeout=120)
    if not torch.cuda.is_available():
        with pytest.raises(RankError, match="is_available"):
            launch(S.serve_cases, {}, [], data=1, model=1, timeout=120)


def test_sequential_mode_rejected_under_mesh():
    cfg, params, ads = zoo("granite-3.2-8b")[1]
    with pytest.raises(ValueError, match="mixed"):
        Engine(cfg, params, adapters=ads, device="cpu",
               engine_cfg=EngineConfig(mesh={"data": 1, "model": 2},
                                       execution_mode="sequential"))


def test_default_engine_has_no_mesh():
    """``mesh=None`` keeps the single-device path: whole pools, no rank
    layout, token buckets from 1."""
    cfg, params, ads = zoo("granite-3.2-8b")[1]
    eng = Engine(cfg, params, adapters=ads, device="cpu",
                 engine_cfg=EngineConfig(**S.ENGINE))
    r = eng.runner
    assert r.mesh is None and r.tp is None and r._tok_bucket_lo == 1
    assert r.k_pool.shape[3] == cfg.num_kv_heads
    assert eng.adapter_pool.layout is None
