"""The spans and wall stamps the port records inside its engine and runner
(``repro_torch.obs.tracer.PORT_SPANS``), on the reduced granite through
``pipelines.base_adapter``: each span once for each event that causes it
and carrying its step number; the upload and embed-copy bytes; the wall
stamps of every request in order (a preempted request keeps its first
admission) and repeated in its lifecycle summary; the Perfetto lifecycle
drawn on the wall clock; and nothing recorded or stamped with tracing
off."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.core.alora import AdapterSpec, init_adapter_weights
from repro_torch.models import init_params
from repro_torch.obs import to_perfetto
from repro_torch.obs.export import PID_LIFECYCLE
from repro_torch.obs.tracer import PORT_SPANS
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.pipelines import base_adapter

torch.set_num_threads(1)

INV = (7, 8, 9)
STAMPS = ("t_submit_wall", "t_admit_wall", "t_first_token_wall",
          "t_done_wall")


@pytest.fixture(scope="module")
def model():
    cfg = get_reduced("granite-3.2-8b")
    g = torch.Generator().manual_seed(0)
    params = init_params(g, cfg, device="cpu")
    ads = [(AdapterSpec(name, 8, inv),
            init_adapter_weights(g, cfg, 8, device="cpu"))
           for name, inv in (("lora", None), ("alora", INV))]
    return cfg, params, ads


def engine(model, **kw):
    cfg, params, ads = model
    ecfg = dict(max_running=4, max_batched_tokens=64, adapter_slots=2)
    ecfg.update(kw)
    return Engine(cfg, params, engine_cfg=EngineConfig(**ecfg),
                  adapters=ads, device="cpu")


def serve(model, **kw):
    """``base_adapter`` (base → both adapters → base) on an engine of
    ``kw``; the engine, with ``_admit`` counting its calls."""
    eng = engine(model, **kw)
    eng.attempts = 0
    admit = eng._admit

    def counted(req):
        eng.attempts += 1
        return admit(req)
    eng._admit = counted
    base_adapter(eng, adapter_names=["lora", "alora"], prompt_len=40,
                 gen_len=6, eval_len=4, batch=3, seed=1,
                 feed_back_to_base=True, final_len=5)
    return eng


def spans(eng, name):
    return [e for e in eng.tracer.events if e[0] == "span" and e[2] == name]


MODES = {"async": {}, "sync": {"async_submission": False},
         "sequential": {"execution_mode": "sequential"}}


@pytest.mark.parametrize("mode", ["async", "sync"])
def test_each_span_once_per_cause(model, mode):
    # 12 blocks: some admissions fail for want of blocks
    eng = serve(model, num_blocks=12, **MODES[mode])
    tr = eng.tracer
    steps = eng.runner.call_counts["mixed_step"]
    assert steps > 0 and tr.dropped == 0
    for name in ("submit.pack", "submit.pad", "submit.upload",
                 "submit.enqueue", "retire.fetch", "retire.book"):
        assert len(spans(eng, name)) == steps, name
    admits = spans(eng, "admit")
    ok = [e for e in admits if e[6]["ok"]]
    assert len(admits) == eng.attempts > len(ok)
    assert len(spans(eng, "admit.embed_copy")) == len(ok) == len(tr.ledger) \
        == tr.counters["admissions_total"]
    # one step's submit spans share its number, one per step, in order;
    # a step's retire spans carry the number of the step that submitted it
    for name in ("submit.pack", "submit.pad", "submit.upload",
                 "submit.enqueue", "retire.fetch", "retire.book"):
        nums = [e[6]["step"] for e in spans(eng, name)]
        assert nums == sorted(set(nums)), name
        assert set(nums) == {e[6]["step"] for e in spans(eng, "submit.pack")}
    for e in spans(eng, "admit") + spans(eng, "admit.embed_copy"):
        assert 1 <= e[6]["step"] <= tr.step
    for name in PORT_SPANS:
        for e in spans(eng, name):
            assert e[3] <= e[4], name
    # the retire phase's span holds the fetch and the bookkeeping
    for outer, fetch, book in zip(spans(eng, "retire"),
                                  spans(eng, "retire.fetch"),
                                  spans(eng, "retire.book")):
        assert outer[3] <= fetch[3] <= fetch[4] <= book[3] <= book[4] \
            <= outer[4]
    # the engine's packing and the runner's padding are t_assembly
    asm = sum(e[4] - e[3] for n in ("submit.pack", "submit.pad")
              for e in spans(eng, n))
    assert asm == pytest.approx(eng.t_assembly + eng.runner.t_assembly,
                                rel=1e-9)


def test_upload_and_embed_copy_bytes(model):
    eng = serve(model)
    d = eng.cfg.d_model
    pads, ups = spans(eng, "submit.pad"), spans(eng, "submit.upload")
    for pad, up in zip(pads, ups):
        Tb, Rb, Cb, nbb, Kb = pad[6]["buckets"]
        # nine int32 and two bool rows a token, the float32 embedding;
        # the active slots, the block table, out rows, run slots and
        # snapshot rows
        staged = Tb * (9 * 4 + 2 + 4 * d) + 4 * (Kb + Rb * nbb + 2 * Rb
                                                 + Cb)
        assert up[6]["bytes"] == staged
    for e in spans(eng, "admit.embed_copy"):
        n = len(eng.request(e[6]["req_id"]).prompt)
        assert e[6]["bytes"] == n * d * 4
    got = sum(e[6]["bytes"] for e in spans(eng, "admit.embed_copy"))
    assert got == 4 * sum(n for n, _, tag in eng.runner.d2h_fetches
                          if tag == "admit")


@pytest.mark.parametrize("mode", list(MODES))
def test_wall_stamps(model, mode):
    eng = serve(model, **MODES[mode])
    first_ok = {}
    for e in spans(eng, "admit"):
        if e[6]["ok"]:
            first_ok.setdefault(e[6]["req_id"], e[4])
    summaries = {e[6]["req_id"]: e[6] for e in eng.tracer.events
                 if e[0] == "request"}
    assert len(summaries) == len(eng.done) > 0
    for r in eng.done:
        t = [getattr(r, k) for k in STAMPS]
        assert None not in t and t == sorted(t), (r.req_id, t)
        assert r.t_admit_wall == first_ok[r.req_id]
        assert [summaries[r.req_id][k] for k in STAMPS] == t


def test_preempted_request_keeps_its_first_admission(model):
    """Six blocks of 16 for three 40-token requests of 12 tokens: the
    engine preempts and re-admits."""
    eng = engine(model, num_blocks=6, admission_policy="fcfs")
    rng = np.random.RandomState(5)
    for _ in range(3):
        eng.submit(list(rng.randint(10, eng.cfg.vocab_size, 40)), 12)
    eng.run_until_idle()
    assert eng.preemptions > 0
    again = {}
    for e in spans(eng, "admit"):
        if e[6]["ok"]:
            again.setdefault(e[6]["req_id"], []).append(e[4])
    readmitted = [rid for rid, ts in again.items() if len(ts) > 1]
    assert readmitted
    for rid in readmitted:
        r = eng.request(rid)
        # the first stamps stay (the first token may come before or
        # after the preemption)
        assert r.t_admit_wall == again[rid][0] < r.t_first_token_wall \
            <= r.t_done_wall
        assert again[rid][-1] < r.t_done_wall


def test_perfetto_draws_lifecycles_on_the_wall_clock(model):
    eng = serve(model)
    doc = to_perfetto([eng.tracer])["traceEvents"]
    life = [e for e in doc if e["pid"] == PID_LIFECYCLE]
    assert {e["args"]["name"] for e in life if e["name"] == "process_name"} \
        == {"replica 0 · requests (wall clock)"}
    for r in eng.done:
        got = {e["name"]: (e["ts"], e["dur"]) for e in life
               if e["tid"] == r.req_id + 1 and e["ph"] == "X"}
        t = [getattr(r, k) * 1e6 for k in STAMPS]
        for name, lo, hi in zip(("queue", "prefill", "decode"), t, t[1:]):
            assert got[name] == (pytest.approx(lo), pytest.approx(hi - lo))
        marks = [e["ts"] for e in life if e["tid"] == r.req_id + 1
                 and e["name"] == "admit"]
        assert marks[0] == pytest.approx(t[1])


def test_tracing_off_records_and_stamps_nothing(model):
    eng = serve(model, trace=False)
    tr = eng.tracer
    assert not tr.events and not tr.ledger and not tr.counters
    assert tr.step == 0 and eng.done
    for r in eng.done:
        assert all(getattr(r, k) is None for k in STAMPS)

