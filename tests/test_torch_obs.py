"""The port's trace exporters (``repro_torch.obs.export``) and tracer
against the reference's (``repro.obs``): on identical synthetic rings,
``to_perfetto``, ``write_perfetto``, ``prometheus_text``,
``trace_records``, ``write_jsonl``, ``reuse_by_adapter`` and
``d2h_summary`` give the same JSON, text and records exactly; the ring
trim and ``set_replica`` behave the same; and after the same reduced
granite pipeline on both engines (and on two-replica fleets of them)
the counter key sets are equal and every counter holds the same value,
so the two Prometheus snapshots are identical text."""
import json

import jax
import numpy as np
import pytest
import torch

from repro import obs as RO
from repro.configs import get_reduced as jax_reduced
from repro.core.alora import AdapterSpec as JSpec
from repro.core.alora import init_adapter_weights as jax_adapter
from repro.models import init_params as jax_init
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JConfig
from repro.serving.router import Router as JRouter
from repro_torch import obs as TO
from repro_torch.configs import get_reduced
from repro_torch.core.alora import AdapterSpec
from repro_torch.models.convert import adapters_from_jax, params_from_jax
from repro_torch.obs import export as TE
from repro_torch.obs import tracer as TT
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.router import Router

# one intra-op thread: this file shares the CPU with the rest of the suite
torch.set_num_threads(1)

INV = (7, 8, 9)


def fill(M, replica, seed):
    """A tracer of package ``M`` holding a synthetic ring with every kind
    of record the exporters render: spans on the phase tracks (with and
    without args or a virtual clock), instants on the pool track and on
    a track outside the vocabulary, lifecycle arrivals, request
    summaries (one without a decode start), ledger rows (base, adapter,
    state reuse) and counters.  Records are written into the rings
    directly, so both packages' rings hold the same timestamps."""
    rng = np.random.RandomState(seed)
    tr = M.Tracer(enabled=True, replica=replica)
    t = 100.0 + seed
    for i in range(4):
        t0 = t + i * 0.25
        tr.span("schedule", "schedule", t0, t0 + 0.01, 0.5 * i,
                {"n_decode": i, "n_prefill": 16 * i})
        tr.span("submit", "submit", t0 + 0.01, t0 + 0.03, 0.5 * i, None)
        tr.span("retire", "retire", t0 + 0.03, t0 + 0.04, None,
                {"rows": i + 1})
    tr.events.append(("event", "pool", "prefetch", t + 2, t + 2, None,
                      {"uid": "ad1#v1"}))
    tr.events.append(("event", "misc", "mark", t + 2.5, t + 2.5, 1.5, None))
    tr.events.append(("event", "router", "placement", t + 2.6, t + 2.6,
                      None, {"req_id": 4, "replica": 1}))
    for rid in range(3):
        uid = None if rid == 0 else f"ad{rid}#v1"
        tr.events.append(("event", "lifecycle", "arrival", t, t,
                          0.1 * rid, {"req_id": rid, "prompt_len": 40,
                                      "adapter_uid": uid}))
        reused = int(rng.randint(0, 3)) * 16
        tr.ledger_entry(rid, uid, reused, 40 - reused, rid == 2,
                        0.2 + rid)
        tr.events.append(("request", "lifecycle", "request", t + 3, t + 3,
                          3.0 + rid, {
                              "req_id": rid, "adapter_uid": uid,
                              "arrival": 0.1 * rid,
                              "t_prefill_start": 0.2 + rid,
                              "t_decode_start": None if rid == 1
                              else 0.7 + rid,
                              "t_done": 3.0 + rid, "prompt_len": 40,
                              "output_len": 6, "cache_hit_tokens": reused}))
    tr.count("steps_total", 4)
    tr.count("d2h_step_transfers_total", 4)
    tr.count("adapter_installs_total", seed % 3)
    tr.dropped = seed % 2
    return tr


def fleet(M):
    return [fill(M, 0, 1), fill(M, 1, 2), fill(M, -1, 3)]


EXPORTS = {
    "to_perfetto": lambda M, trs: M.to_perfetto(trs),
    "prometheus_text": lambda M, trs: M.prometheus_text(trs),
    "trace_records": lambda M, trs: M.trace_records(trs),
    "reuse_by_adapter": lambda M, trs: M.reuse_by_adapter(trs),
}


@pytest.mark.parametrize("name", list(EXPORTS))
@pytest.mark.parametrize("n", [1, 3])
def test_exports_match_reference_on_synthetic_rings(name, n):
    got = EXPORTS[name](TO, fleet(TO)[:n])
    want = EXPORTS[name](RO, fleet(RO)[:n])
    assert got == want
    json.dumps(got)


def test_written_files_match_reference(tmp_path):
    for M, tag in ((TO, "port"), (RO, "ref")):
        M.write_perfetto(str(tmp_path / f"{tag}.json"), fleet(M))
        M.write_jsonl(str(tmp_path / f"{tag}.jsonl"), fleet(M))
    for ext in ("json", "jsonl"):
        assert (tmp_path / f"port.{ext}").read_bytes() == \
            (tmp_path / f"ref.{ext}").read_bytes()


def test_d2h_summary_matches_reference():
    rows = [(3, "int32", "step"), (2, "int32", "step"),
            (128, "float32", "admit"), (7, "float32", "encode")]
    assert TO.d2h_summary(rows) == RO.d2h_summary(rows)


def test_schema_constants_match_reference():
    from repro.obs import export as RE
    from repro.obs import tracer as RT
    for k in ("EVENT_FIELDS", "LEDGER_FIELDS", "TRACKS", "TRACE_RING_MAX",
              "TRACE_RING_KEEP"):
        assert getattr(TT, k) == getattr(RT, k), k
    for k in ("PID_PHASE", "PID_LIFECYCLE", "PID_ROUTER", "TRACK_TIDS"):
        assert getattr(TE, k) == getattr(RE, k), k


@pytest.mark.parametrize("replica", [0, 3, -1])
def test_set_replica_moves_the_tracks(replica):
    """``set_replica`` restamps a tracer's fleet position: its phase
    process becomes ``PID_PHASE + replica`` (the router's at -1) and its
    counters carry that label, as in the reference."""
    got, want = fill(TO, 0, 5), fill(RO, 0, 5)
    got.set_replica(replica)
    want.set_replica(replica)
    assert got.replica == replica
    doc = TO.to_perfetto([got])
    assert doc == RO.to_perfetto([want])
    phase = TE.PID_ROUTER if replica < 0 else TE.PID_PHASE + replica
    assert phase in {e["pid"] for e in doc["traceEvents"]}
    label = "router" if replica < 0 else str(replica)
    assert f'{{replica="{label}"}}' in TO.prometheus_text([got])


@pytest.mark.parametrize("extra", [0, 10])
def test_ring_trim_matches_reference(extra):
    trs = []
    for M in (TO, RO):
        tr = M.Tracer(enabled=True)
        for i in range(M.TRACE_RING_MAX + extra):
            tr.span("schedule", "s", float(i), float(i) + 0.5, None)
        trs.append(tr)
    got, want = trs
    assert len(got.events) == len(want.events)
    assert got.dropped == want.dropped
    assert (got.dropped > 0) == (extra > 0)
    assert got.events == want.events
    assert TO.trace_records([got])[-1] == RO.trace_records([want])[-1]


# ---------------------------------------------------------------------------
# the same pipeline on both engines: counter keys and values
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    cfg_j = jax_reduced("granite-3.2-8b")
    cfg = get_reduced("granite-3.2-8b")
    pj = jax_init(jax.random.key(0), cfg_j)
    ads = [jax_adapter(jax.random.key(100 + i), cfg_j, 8) for i in (0, 1)]
    return dict(cfg_j=cfg_j, cfg=cfg, pj=pj, ads=ads,
                params=params_from_jax(jax.tree.map(np.asarray, pj), cfg,
                                       "cpu"),
                tads=[adapters_from_jax(jax.tree.map(np.asarray, a), cfg,
                                        "cpu") for a in ads])


def multiturn(target, cfg, sessions=3, turns=2, gen=4, seed=3):
    """The reference's ``tests/test_obs.py::run_multiturn`` trace: each
    round runs to idle before the next extends its prompts; odd turns
    go to ad0 (vanilla LoRA) and ad1 (aLoRA)."""
    rng = np.random.RandomState(seed)
    hi = min(400, cfg.vocab_size)
    convo = [list(rng.randint(10, hi, 24 + 4 * (s % 3)))
             for s in range(sessions)]
    ids = []
    for t in range(turns):
        round_ids = [target.submit(convo[s], gen,
                                   adapter_name=f"ad{s % 2}" if t % 2
                                   else None)
                     for s in range(sessions)]
        target.run_until_idle()
        for s, rid in enumerate(round_ids):
            out = target.request(rid).output_tokens
            convo[s] = convo[s] + list(out) + list(rng.randint(10, hi, 12))
        ids.extend(round_ids)
    return ids


def tiers(weights, replicas):
    """The reference's and the port's engine (or two-replica router) on
    the same converted weights."""
    kw = dict(max_running=4, max_batched_tokens=64, adapter_slots=2)
    specs = [("ad0", None), ("ad1", INV)]

    def jeng():
        return JEngine(weights["cfg_j"], weights["pj"],
                       engine_cfg=JConfig(**kw),
                       adapters=[(JSpec(n, 8, inv), weights["ads"][i])
                                 for i, (n, inv) in enumerate(specs)])

    def teng():
        return Engine(weights["cfg"], weights["params"], device="cpu",
                      engine_cfg=EngineConfig(**kw),
                      adapters=[(AdapterSpec(n, 8, inv), weights["tads"][i])
                                for i, (n, inv) in enumerate(specs)])
    if replicas == 1:
        return jeng(), teng()
    return (JRouter([jeng() for _ in range(replicas)]),
            Router([teng() for _ in range(replicas)]))


def tracers(tier):
    if hasattr(tier, "replicas"):
        return [e.tracer for e in tier.replicas] + [tier.tracer]
    return [tier.tracer]


@pytest.mark.parametrize("replicas", [1, 2])
def test_pipeline_counters_match_reference(weights, replicas):
    ref, port = tiers(weights, replicas)
    ids_r = multiturn(ref, weights["cfg_j"])
    ids_p = multiturn(port, weights["cfg"])
    assert ids_p == ids_r
    for gid in ids_r:
        assert port.request(gid).output_tokens == \
            ref.request(gid).output_tokens, gid
    got, want = tracers(port), tracers(ref)
    for g, w in zip(got, want):
        assert g.replica == w.replica
        assert set(g.counters) == set(w.counters)
        assert g.counters == w.counters
        # the ledger without its virtual-clock stamp
        assert [r[:5] for r in g.ledger] == [r[:5] for r in w.ledger]
    assert TO.prometheus_text(got) == RO.prometheus_text(want)
    assert TO.reuse_by_adapter(got) == RO.reuse_by_adapter(want)
    # the Perfetto layout (processes, threads, names) is the same, once
    # the spans only the port records inside the phases are set aside
    def key(e):
        return e["pid"], e["tid"], e["name"], e["ph"]
    def port_only(e):
        return e["ph"] == "X" and e["name"] in TT.PORT_SPANS
    drawn = TO.to_perfetto(got)["traceEvents"]
    shared = [e for e in drawn if not port_only(e)]
    assert {e["name"] for e in drawn if port_only(e)} == set(TT.PORT_SPANS)
    assert sorted(map(key, shared)) == \
        sorted(map(key, RO.to_perfetto(want)["traceEvents"]))
    # the reused-token counter reconciles with the prefix cache's hits
    engines = port.replicas if replicas > 1 else [port]
    reused = sum(r[2] for t in got for r in t.ledger)
    assert reused == sum(e.kv_mgr.hits for e in engines) \
        * engines[0].ecfg.block_size > 0
    assert sum(t.counters.get("tokens_reused_total", 0) for t in got) \
        == reused
