"""The port's paper-figure benches (``repro_torch.benchmarks``: Figs.
8/9, 10, 11, 15 and §4.4.1) and its section runner on the CPU against
the reference's ``benchmarks/`` on the same weights: the
reference bench's own ``benchmarks.common.model()`` and adapter weights
(``jax.random.key(100 + i)``), converted.  Each port bench runs its
``--smoke`` form (its asserts included); the reference drives the same
workload through its own bench helpers or pipelines on
``benchmarks.common.make_engine``.  Compared: tokens (float32, exact),
reused prompt tokens and ``cache_hit_frac``, and
the tight pool's evictions.  ``test_torch_bench_legs.py`` does the same
for the churn, Zipf, mixed-batch and router benches."""
import jax
import numpy as np
import pytest
import torch

from benchmarks import common as RC
from repro.core.alora import init_adapter_weights as jax_adapter
from repro.serving import EngineConfig as JConfig
from repro.serving import pipelines as JP
from repro_torch.benchmarks import (bench_adapter_base, bench_async,
                                    bench_batch_size,
                                    bench_generation_length,
                                    bench_multi_adapter, common, run)
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


def test_fig11_adapter_base():
    rows = bench_adapter_base.run(smoke=True, device="cpu")
    plen = bench_adapter_base.PROMPT_LENS[0]
    jeng = RC.make_engine("alora")
    jres = JP.adapter_base(jeng, adapter_name="ad0", prompt_len=plen,
                           eval_len=16, gen_len=16, batch=2, seed=plen)
    row = rows[f"fig11/base-after-adapter/alora/prompt{plen}"]
    same(row, ref_stage(jeng, jres.eval_ids + jres.final_ids))
    assert row["hit"] == jres.stage_metrics(jeng, "final").means[
        "cache_hit_frac"] > 0
    # only the aLoRA adapter's pre-activation blocks serve the base
    assert rows[f"fig11/base-after-adapter/lora/prompt{plen}"]["hit"] == 0


def test_fig15_batch_size():
    rows = bench_batch_size.run(smoke=True, device="cpu")
    b = bench_batch_size.BATCHES[0]
    jeng = RC.make_engine("alora", ecfg=JConfig(max_running=8))
    jres = JP.base_adapter(jeng, adapter_names=["ad0"], prompt_len=48,
                           gen_len=24, eval_len=8, batch=b, seed=b)
    row = rows[f"fig15/eval/batch{b}"]
    same(row, ref_stage(jeng, jres.base_ids + jres.eval_ids))
    assert row["hit"] == jres.stage_metrics(jeng, "eval").means[
        "cache_hit_frac"] > 0


def test_fig10_generation_length():
    rows = bench_generation_length.run(smoke=True, device="cpu")
    g = bench_generation_length.GEN_LENS[0]
    for kind in ("lora", "alora"):
        jeng = RC.make_engine(kind)
        jres = JP.base_adapter(jeng, adapter_names=["ad0"], prompt_len=48,
                               gen_len=g, eval_len=8, batch=2,
                               feed_back_to_base=True, seed=g)
        for stage, ids in (("eval", jres.eval_ids),
                           ("final-base", jres.final_ids)):
            row = rows[f"fig10/{stage}/{kind}/gen{g}"]
            same(row, ref_stage(jeng, ids))
            assert row["hit"] == jres.stage_metrics(
                jeng, stage.split("-")[0]).means["cache_hit_frac"]


def test_fig8_async_and_capacity_cliff():
    """With ``time_scale=0`` on both sides the virtual clock moves only
    to arrivals, so the schedules (and the tight pool's evictions) do
    not depend on either host's speed.  The reference drives the tight
    pool (the async pipeline itself is held to it in
    ``test_torch_serve.py``)."""
    rows = bench_async.run(smoke=True, device="cpu", time_scale=0.0)
    rate = bench_async.RATES[0]
    assert rows[f"fig8/eval/alora/rate{rate}"]["hit"] > 0
    assert rows[f"fig8/eval/lora/rate{rate}"]["hit"] == 0
    for blocks, label in bench_async.CAPACITY[1:]:
        jeng = RC.make_engine("alora", ecfg=JConfig(num_blocks=blocks,
                                                    time_scale=0.0))
        jres = JP.async_base_adapter(jeng, adapter_name="ad0",
                                     arrival_rate=32.0, num_requests=8,
                                     prompt_len=96, gen_len=24, eval_len=8,
                                     seed=7)
        row = rows[f"fig9/capacity-{label}/blocks{blocks}"]
        same(row, ref_stage(jeng, jres.eval_ids))
        assert row["evictions"] == jeng.kv_mgr.evictions
    assert rows["fig9/capacity-tight/blocks24"]["evictions"] > 0


def test_sec441_five_adapters():
    rows = bench_multi_adapter.run(device="cpu")
    names = [f"ad{i}" for i in range(bench_multi_adapter.N_ADAPTERS)]
    jeng = RC.make_engine("alora", n_adapters=len(names))
    jres = JP.base_adapter(jeng, adapter_names=names, prompt_len=64,
                           gen_len=32, eval_len=8, feed_back_to_base=True,
                           seed=4)
    same(rows["sec441/eval-5adapters/alora"], ref_stage(jeng, jres.eval_ids))
    same(rows["sec441/final-base/alora"], ref_stage(jeng, jres.final_ids))


def test_run_sections(capsys):
    run.main(["--device", "cpu", "fig15"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert out[-1].startswith("section/fig15/wall_s,")
    assert set(run.sections()) == {"mixed_batch", "mixed_batch_tp", "fig11",
                                   "fig10", "fig8", "sec441", "fig15",
                                   "kernels", "roofline"}
    with pytest.raises(SystemExit):
        run.main(["fig6"])


def test_benches_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_batch_size.run(smoke=True)
