"""The port's serving launcher (``repro_torch.launch.serve``) and
pipeline functions against the reference's on the reduced granite with
converted weights: the launcher's vanilla-LoRA and aLoRA legs
(``build_engine`` + ``pipelines.base_adapter(feed_back_to_base=True)``,
on one engine and on a two-replica router), ``adapter_base`` and
``async_base_adapter`` give the same request ids, tokens,
``n_cache_hit_tokens`` and per-stage ``cache_hit_frac`` (exact: both are
ratios of the same integers); the adapters the launcher draws have the
reference's specs; ``main(["--device", "cpu", ...])`` runs to its
speedup line and writes artifacts that parse; and without a card the
default device raises."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core.alora import init_adapter_weights as jax_adapter
from repro.launch import serve as RS
from repro.models import init_params as jax_init
from repro.serving import EngineConfig as JConfig
from repro.serving import pipelines as JP
from repro_torch.configs import get_reduced
from repro_torch.launch import serve as TS
from repro_torch.models.convert import adapters_from_jax, params_from_jax
from repro_torch.serving import EngineConfig
from repro_torch.serving import pipelines as P

# one intra-op thread: this file shares the CPU with the rest of the suite
torch.set_num_threads(1)

PIPE = dict(prompt_len=32, gen_len=6, eval_len=4, batch=2)
STAGES = ("base", "eval", "final")


@pytest.fixture(scope="module")
def weights():
    cfg_j = jax_reduced("granite-3.2-8b")
    cfg = get_reduced("granite-3.2-8b")
    pj = jax_init(jax.random.key(0), cfg_j)
    return dict(cfg_j=cfg_j, cfg=cfg, pj=pj,
                params=params_from_jax(jax.tree.map(np.asarray, pj), cfg,
                                       "cpu"))


def launcher_adapters(w, kind, n=1):
    """The reference launcher's adapters (``jax.random.key(100 + i)`` at
    the paper's rank), converted, under the port launcher's specs."""
    return [(spec, adapters_from_jax(jax.tree.map(np.asarray, jax_adapter(
        jax.random.key(100 + i), w["cfg_j"], spec.rank)), w["cfg"], "cpu"))
        for i, spec in enumerate(TS.adapter_specs(kind, n))]


def assert_same_stages(eng, res, jeng, jres):
    for stage in STAGES:
        ids = getattr(res, f"{stage}_ids")
        assert ids == getattr(jres, f"{stage}_ids"), stage
        for rid in ids:
            got, want = eng.request(rid), jeng.request(rid)
            assert got.output_tokens == want.output_tokens, (stage, rid)
            assert got.n_cache_hit_tokens == want.n_cache_hit_tokens, \
                (stage, rid)
        if ids:
            assert res.stage_metrics(eng, stage).means["cache_hit_frac"] \
                == jres.stage_metrics(jeng, stage).means["cache_hit_frac"]


@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("kind", TS.KINDS)
def test_launcher_leg_matches_reference(weights, kind, replicas):
    w = weights
    jeng = RS.build_engine(w["cfg_j"], w["pj"], kind, 1, replicas=replicas)
    eng = TS.build_engine(w["cfg"], w["params"],
                          launcher_adapters(w, kind), replicas=replicas,
                          device="cpu")
    names = ["intrinsic0"]
    jres = JP.base_adapter(jeng, adapter_names=names, seed=0,
                           feed_back_to_base=True, **PIPE)
    res = P.base_adapter(eng, adapter_names=names, seed=0,
                         feed_back_to_base=True, **PIPE)
    assert_same_stages(eng, res, jeng, jres)
    evals = [eng.request(i).n_cache_hit_tokens for i in res.eval_ids]
    finals = [eng.request(i).n_cache_hit_tokens for i in res.final_ids]
    # aLoRA evals reuse the base request's blocks, LoRA evals none; the
    # final base request reuses them in both legs
    assert all(h == 32 for h in evals) if kind == "alora" \
        else not any(evals)
    assert all(h >= 32 for h in finals)
    if replicas > 1:
        assert [(p.replica, p.cached_tokens) for p in eng.placements] == \
            [(p.replica, p.cached_tokens) for p in jeng.placements]
        assert eng.kv_hit_rate() == jeng.kv_hit_rate()


def test_launcher_adapters_have_the_reference_specs(weights):
    gen = torch.Generator().manual_seed(0)
    for kind in TS.KINDS:
        ads = TS.init_adapters(gen, weights["cfg"], kind, 2, device="cpu")
        jeng = RS.build_engine(weights["cfg_j"], weights["pj"], kind, 2)
        assert [(s.name, s.rank, s.invocation_tokens, s.kind)
                for s, _ in ads] == [
            (r.spec.name, r.spec.rank, r.spec.invocation_tokens,
             r.spec.kind) for r in jeng.adapters.values()]
    with pytest.raises(ValueError):
        TS.adapter_specs("dora")


def test_adapter_base_matches_reference(weights):
    w = weights
    jeng = RS.build_engine(w["cfg_j"], w["pj"], "alora", 1)
    eng = TS.build_engine(w["cfg"], w["params"],
                          launcher_adapters(w, "alora"), device="cpu")
    kw = dict(adapter_name="intrinsic0", prompt_len=40, eval_len=4,
              gen_len=6, batch=3, seed=5)
    jres = JP.adapter_base(jeng, **kw)
    res = P.adapter_base(eng, **kw)
    assert_same_stages(eng, res, jeng, jres)
    # the base request reuses the adapter's pre-activation blocks
    assert all(eng.request(i).n_cache_hit_tokens >= 32
               for i in res.final_ids)


def test_async_base_adapter_matches_reference(weights):
    """Poisson arrivals from the same numpy seed; with ``time_scale=0``
    the virtual clock moves only to the next arrival, so both engines
    see one schedule."""
    w = weights
    jeng = RS.build_engine(w["cfg_j"], w["pj"], "alora", 1,
                           engine_cfg=JConfig(time_scale=0.0))
    eng = TS.build_engine(w["cfg"], w["params"],
                          launcher_adapters(w, "alora"),
                          EngineConfig(time_scale=0.0), device="cpu")
    kw = dict(adapter_name="intrinsic0", arrival_rate=4.0, num_requests=4,
              prompt_len=30, gen_len=5, eval_len=3, seed=2)
    jres = JP.async_base_adapter(jeng, **kw)
    res = P.async_base_adapter(eng, **kw)
    assert_same_stages(eng, res, jeng, jres)
    assert [eng.request(i).arrival_time for i in res.base_ids] == \
        [jeng.request(i).arrival_time for i in jres.base_ids]
    assert len(res.eval_ids) == 4
    assert all(eng.request(i).n_cache_hit_tokens > 0 for i in res.eval_ids)


@pytest.mark.parametrize("replicas", [1, 2])
def test_main_runs_to_the_speedup_line(tmp_path, capsys, replicas):
    trace, prom = tmp_path / "trace.json", tmp_path / "metrics.txt"
    TS.main(["--device", "cpu", "--requests", "2", "--prompt-len", "24",
             "--gen-len", "4", "--eval-len", "3", "--replicas",
             str(replicas), "--trace-out", str(trace), "--metrics-out",
             str(prom)])
    out = capsys.readouterr().out
    assert "adapter-evaluation speedups (LoRA baseline / aLoRA): e2e=" in out
    for kind in TS.KINDS:
        for stage in STAGES:
            assert f"  {kind:5s} {stage:5s} e2e=" in out
    pids = {e["pid"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert set(range(1, 1 + replicas)) <= pids
    assert (2001 in pids) == (replicas > 1)
    text = prom.read_text()
    assert "# TYPE repro_tokens_reused_total counter" in text
    assert ("placements_total" in text) == (replicas > 1)


def test_main_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.main([])
