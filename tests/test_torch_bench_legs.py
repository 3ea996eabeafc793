"""The port's scheduling and serving-tier benches on the CPU against the
reference's on the same (converted) weights, as in
``test_torch_benchmarks.py``: the adapter-churn and Zipf legs of
``bench_multi_adapter``, ``bench_mixed_batch`` (the reference CI's
``--smoke --async --trace-check`` and ``--arch mamba2-2.7b --smoke``
legs) and ``bench_router``.  Compared: tokens (float32, exact), reused
prompt tokens, the adapter pool's counters (evictions, acquire fails,
stalled installs, ...), queue waits in steps, placements and fleet hit
rates; one mixed-step call per work step."""
import json

import jax
import numpy as np
import pytest
import torch

from benchmarks import bench_mixed_batch as RMB
from benchmarks import bench_multi_adapter as RMA
from benchmarks import bench_router as RBR
from benchmarks import common as RC
from repro.core.alora import init_adapter_weights as jax_adapter
from repro.serving import EngineConfig as JConfig
from repro_torch.benchmarks import (bench_mixed_batch, bench_multi_adapter,
                                    bench_router, common)
from repro_torch.configs import get_reduced
from repro_torch.models.convert import adapters_from_jax, params_from_jax

# one intra-op thread: this file shares the CPU with the rest of the suite
torch.set_num_threads(1)

ARCH = "granite-3.2-8b"


@pytest.fixture(scope="module", autouse=True)
def converted(tmp_path_factory):
    """Serve the port's benches from the reference bench's model."""
    cfg_j, pj = RC.model(ARCH)
    cfg = get_reduced(ARCH)
    weights = {}

    def adapter_weights(rank, i):
        if (rank, i) not in weights:
            # the reference bench's own draw, kept in its cache
            key = (ARCH, "w", rank, i)
            if key not in RC._cache:
                RC._cache[key] = jax_adapter(jax.random.key(100 + i), cfg_j,
                                             rank)
            weights[(rank, i)] = adapters_from_jax(jax.tree.map(
                np.asarray, RC._cache[key]), cfg, "cpu")
        return weights[(rank, i)]

    common.install(ARCH, cfg, params_from_jax(
        jax.tree.map(np.asarray, pj), cfg, "cpu"), adapter_weights)
    saved = common.RESULTS
    common.RESULTS = str(tmp_path_factory.mktemp("results"))
    yield
    common.RESULTS = saved
    common.uninstall()


def ref_stage(jeng, ids):
    return dict(tokens=[list(jeng.request(i).output_tokens) for i in ids],
                hits=[jeng.request(i).n_cache_hit_tokens for i in ids])


def same(row, want):
    for k, v in want.items():
        assert row[k] == v, k


def test_churn_smoke():
    rows = bench_multi_adapter.run_churn(ARCH, smoke=True, device="cpu")
    jeng = RC.make_engine("alora", n_adapters=4,
                          ecfg=JConfig(max_running=4, adapter_slots=2))
    rids, steps, _, _ = RMA._churn_workload(
        jeng, n_adapters=4, reps=2, prompt_len=24, gen_len=6, seed=7)
    lat = rows[f"adapter_churn/{ARCH}/step_latency"]
    same(lat, ref_stage(jeng, rids))
    calls = rows[f"adapter_churn/{ARCH}/device_calls_per_step"]
    assert calls["calls"] == calls["steps"] == steps
    assert calls["oracle_tokens"] == lat["tokens"]
    got = rows[f"adapter_churn/{ARCH}/adapter_pool"]["stats"]
    want = jeng.adapter_pool_stats().row()
    assert got == want and got["evictions"] > 0


def test_zipf_smoke():
    rows = bench_multi_adapter.run_zipf(ARCH, smoke=True, device="cpu")
    # the reference under the affinity scheduler (the FCFS leg is the
    # port bench's own oracle, asserted above it)
    ids = RMA._zipf_trace(32, 72, 1.2, seed=11)
    jeng = RC.make_engine("alora", n_adapters=32, ecfg=JConfig(
        max_running=6, adapter_slots=2, adapter_staging_budget=2,
        admission_policy="affinity"))
    rids, steps, _, admit = RMA._zipf_workload(jeng, ids, prompt_len=24,
                                               gen_len=8, seed=7)
    row = rows[f"adapter_sched/{ARCH}/affinity/queue_latency"]
    same(row, ref_stage(jeng, rids))
    assert row["steps"] == steps
    assert row["wait"] == float(np.mean([admit[r] for r in rids]))
    assert row["stats"] == jeng.adapter_pool_stats().row()
    f = rows[f"adapter_sched/{ARCH}/fcfs/queue_latency"]["stats"]
    a = rows[f"adapter_sched/{ARCH}/affinity/queue_latency"]["stats"]
    assert a["acquire_fails"] < f["acquire_fails"]
    assert a["stalled_installs"] < f["stalled_installs"]
    toks = rows[f"adapter_sched/{ARCH}/uncontended/fcfs_vs_affinity"][
        "tokens"]
    assert toks["fcfs"] == toks["affinity"]


@pytest.mark.parametrize("arch", [ARCH, "mamba2-2.7b"])
def test_mixed_batch_smoke(arch):
    """The reference's CI legs: ``--smoke --async --trace-check`` on
    granite and ``--arch mamba2-2.7b --smoke``.  The synchronous mixed
    mode's tokens and hits equal the reference's; every mode makes one
    mixed-step call per work step."""
    if arch != ARCH:
        cfg_j, pj = RC.model(arch)
        cfg = get_reduced(arch)
        common.install(arch, cfg, params_from_jax(
            jax.tree.map(np.asarray, pj), cfg, "cpu"),
            lambda rank, i: adapters_from_jax(jax.tree.map(
                np.asarray, jax_adapter(jax.random.key(100 + i), cfg_j,
                                        rank)), cfg, "cpu"))
    rows = bench_mixed_batch.run(arch, smoke=True, async_leg=arch == ARCH,
                                 trace_check=arch == ARCH, device="cpu")
    jeng = RC.make_engine("alora", arch=arch, ecfg=JConfig(
        max_running=8, max_batched_tokens=128, async_submission=False))
    rids, steps, _, _ = RMB._workload(jeng, 7, 3, 24, 8)
    want = ref_stage(jeng, rids)
    for mode in ("sequential", "mixed", "mixed_async")[:3 if arch == ARCH
                                                        else 2]:
        row = rows[f"mixed_batch/{arch}/{mode}/step_latency"]
        same(row, want)
        assert row["steps"] == steps
        if mode != "sequential":
            assert row["calls"] == steps
    if arch == ARCH:
        assert rows[f"mixed_batch/{arch}/mixed_async/vs_sync_submission"][
            "d2h_max"] < jeng.cfg.vocab_size
        assert rows[f"mixed_batch/{arch}/trace_overhead"]["events"] > 0


def test_mixed_batch_mesh_smoke():
    """``--smoke --mesh model=2`` on two CPU ranks: the tensor-parallel
    leg's tokens equal the reference's mixed mode's, with one mixed-step
    call per work step, and its record is appended."""
    rows = bench_mixed_batch.run(ARCH, smoke=True, device="cpu",
                                 mesh={"data": 1, "model": 2})
    jeng = RC.make_engine("alora", arch=ARCH, ecfg=JConfig(
        max_running=8, max_batched_tokens=128, async_submission=False))
    rids, steps, _, _ = RMB._workload(jeng, 7, 3, 24, 8)
    row = rows[f"mixed_batch/{ARCH}/mixed@1x2/step_latency"]
    assert row["tokens"] == ref_stage(jeng, rids)["tokens"]
    assert row["steps"] == row["calls"] == steps
    with open(common.results_path("sharded_step.jsonl")) as f:
        rec = json.loads(f.read().splitlines()[-1])
    assert rec["mesh"] == "1x2" and rec["device_calls_per_step"] == 1.0


def test_router_smoke():
    rows = bench_router.run(ARCH, smoke=True, device="cpu")
    ecfg = JConfig(max_running=4, max_batched_tokens=64, adapter_slots=2)
    # R = 1 is one engine under both policies (the bench asserts equal
    # hit rates); the reference drives the two-replica fleet
    assert rows[f"router/{ARCH}/R1/affinity/fleet_hit_rate"]["tokens"] == \
        rows[f"router/{ARCH}/R1/round_robin/fleet_hit_rate"]["tokens"]
    for n in (2,):
        for policy in ("affinity", "round_robin"):
            router = RBR.Router([RC.make_engine("alora", n_adapters=2,
                                                ecfg=ecfg)
                                 for _ in range(n)], policy=policy)
            gids = RBR._run_trace(router, ARCH, 7, 5, 2)
            row = rows[f"router/{ARCH}/R{n}/{policy}/fleet_hit_rate"]
            assert row["hit_rate"] == router.kv_hit_rate()
            assert row["placements"] == [(p.replica, p.cached_tokens)
                                         for p in router.placements]
            assert row["tokens"] == [list(router.request(g).output_tokens)
                                     for g in gids]
