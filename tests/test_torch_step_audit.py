"""The port's step audit (Pass A, ``repro_torch.analysis.step_audit``):
each check firing and staying silent on synthetic step traces (the
counterpart of ``tests/test_analysis.py``'s HLO snippets), the real
audit of reduced granite, mamba2 and whisper on the CPU (granite's
donated pools equal to the reference audit's), mutations of the real
step that the audit must catch, one world of 2x4 CPU ranks against the
checked-in golden, the goldens themselves, and the CLI's exit-code and
artifact contract."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.analysis import step_audit as sa
from repro_torch.analysis.step_trace import (Op, PoolState, StepTrace,
                                             TensorMeta)
from repro_torch.configs import list_archs
from repro_torch.models import layers as Lyr
from repro_torch.serving.runner import D2H_LOG_MAX, ModelRunner

torch.set_num_threads(1)


def meta(shape, dtype="float32", device="cpu", storage=0):
    return TensorMeta(tuple(shape), dtype, device, storage)


def pool(shape, dtype="float32", ptr=1, before=0, after=1):
    return PoolState(meta(shape, dtype, storage=ptr), ptr, ptr, before, after)


def clean_trace(**kw) -> StepTrace:
    """A step trace of a two-layer attention stack that passes every
    check."""
    t = StepTrace(
        device="cpu",
        ops=[Op("aten.mm.default", (meta((4, 8), storage=10),
                                    meta((8, 8), storage=11)),
                (meta((4, 8), storage=12),)),
             Op("plain:ragged_paged_attention", (meta((4, 2, 4)),),
                (meta((4, 2, 4), storage=13),)),
             Op("aten.argmax.default", (meta((4, 64), storage=14),),
                (meta((4,), "int64", storage=15),))],
        outputs=[("sampled", meta((4,), "int32", storage=16))],
        pools={"k_pool": pool((2, 16, 4, 2, 4), ptr=100),
               "v_pool": pool((2, 16, 4, 2, 4), ptr=101),
               "tok_buf": pool((5,), "int32", ptr=102)},
        persistent={"params/layers/0/attn/wq": (0, 0)},
        names={11: "params/layers/0/attn/wq"},
        bucket=(4, 4, 1, 2, 1))
    for k, v in kw.items():
        setattr(t, k, v)
    return t


# ------------------------------------------------------------- A1
def test_a1_silent_on_a_clean_step():
    assert sa.check_host_roundtrips(clean_trace()) == []


@pytest.mark.parametrize("op", [
    Op("aten._local_scalar_dense.default", (meta((), "int32"),), ()),
    Op("aten._to_copy.default", (meta((4,), "int32", "cuda"),),
       (meta((4,), "int32", "cpu"),))], ids=["item", "copy-to-host"])
def test_a1_fires_on_a_host_round_trip(op):
    t = clean_trace()
    t.ops.insert(1, op)
    v = sa.check_host_roundtrips(t)
    assert len(v) == 1 and v[0].startswith("host-sync: op #1")


def test_a1_fires_on_a_sync_the_debug_mode_raised():
    t = clean_trace(sync_error="called a synchronizing CUDA operation")
    assert "synchronising CUDA call" in sa.check_host_roundtrips(t)[0]


# ------------------------------------------------------------- A2
def test_a2_silent_on_the_ids_only_payload():
    assert sa.check_payload(clean_trace(), vocab_size=64, max_running=5) \
        == []
    assert sa.check_fetches([(96, "float32", "admit"), (4, "int32", "step"),
                             (2, "int32", "step")], 2, 5) == []


def test_a2_fires_on_a_logits_sized_output():
    t = clean_trace(outputs=[("sampled", meta((4,), "int32")),
                             ("logits", meta((4, 64)))])
    v = sa.check_payload(t, vocab_size=64, max_running=5)
    assert any("not part of the ids-only" in x for x in v)
    assert any("vocab-sized dim [4, 64]" in x for x in v)


def test_a2_fires_on_a_wide_sampled_output():
    t = clean_trace(outputs=[("sampled", meta((16,), "int64"))])
    v = sa.check_payload(t, vocab_size=64, max_running=5)
    assert v == ["payload: sampled is int64[16]; expected 1-D int32 of ≤ 8 "
                 "rows"]


def test_a2_fires_on_extra_or_wide_fetches():
    v = sa.check_fetches([(4, "int32", "step"), (4, "float32", "step"),
                          (64, "float32", "logits")], 1, 5)
    assert any("'logits' device→host" in x for x in v)
    assert any("2 'step' fetches over 1" in x for x in v)
    assert any("4 x float32" in x for x in v)


# ------------------------------------------------------------- A3
def test_a3_silent_when_the_pools_update_in_place():
    v, donated = sa.check_donation(clean_trace(), La=2, Ls=0)
    assert v == [] and donated == ["k_pool", "tok_buf", "v_pool"]


def test_a3_fires_on_a_reallocated_pool():
    t = clean_trace()
    t.pools["k_pool"] = dataclasses.replace(t.pools["k_pool"], ptr_after=7)
    v, donated = sa.check_donation(t, La=2, Ls=0)
    assert v == ["donation: k_pool was replaced by a new tensor in the step "
                 "— its memory doubles every step"]
    assert donated == ["tok_buf", "v_pool"]


def test_a3_fires_on_a_pool_left_unwritten_and_a_missing_ssm_pool():
    t = clean_trace()
    t.pools["tok_buf"] = pool((5,), "int32", ptr=102, after=0)
    v, _ = sa.check_donation(t, La=2, Ls=1)
    assert "donation: tok_buf was not updated in place by the step" in v
    assert "donation: expected pool 'live_ssm' absent" in v


def test_a3_fires_on_a_stray_in_place_write_to_a_param():
    t = clean_trace(persistent={"params/layers/0/attn/wq": (0, 1)})
    v, _ = sa.check_donation(t, La=2, Ls=0)
    assert v == ["donation: the step wrote params/layers/0/attn/wq in place "
                 "(version 0 -> 1) — only the pools may change"]


def test_a3_fires_on_a_pool_layer_rebuilt_out_of_place():
    t = clean_trace()
    t.ops.append(Op("aten.index_put.default", (meta((16, 4, 2, 4),
                                                    storage=100),),
                    (meta((16, 4, 2, 4), storage=200),)))
    v, _ = sa.check_donation(t, La=2, Ls=0)
    assert v == ["donation: op #3 aten.index_put.default allocates "
                 "float32[16, 4, 2, 4], the shape of a layer of k_pool or a "
                 "layer of v_pool — a pool rebuilt out of place"]


# ------------------------------------------------------------- A4
def test_a4_silent_on_the_golden_and_fires_with_a_readable_diff():
    seen = {"counts": {"all-reduce": 5, "all-gather": 6},
            "result_bytes": {"all-reduce": 100, "all-gather": 60}}
    assert sa.diff_fingerprint("g", "2x4", seen, dict(seen)) == ""
    golden = {"counts": {"all-reduce": 4}, "result_bytes": {"all-reduce": 80}}
    d = sa.diff_fingerprint("g", "2x4", seen, golden)
    assert d.startswith("g [2x4]: collective fingerprint drift")
    assert "all-gather           NEW op   count 0 -> 6 (+6), bytes 0 -> 60" \
        in d
    assert "all-reduce           drifted  count 4 -> 5 (+1), bytes 80 -> " \
        "100 (+20)" in d
    assert "likely knob: the mesh `model` axis / RankLayout" in d
    assert "--update-goldens --device cpu" in sa.diff_fingerprint(
        "g", "2x4", seen, None)


def test_a4_fingerprint_reads_the_collective_counter():
    t = clean_trace(collectives={"all-reduce": {"count": 2, "bytes": 64}})
    assert sa.fingerprint_of(t) == {"counts": {"all-reduce": 2},
                                    "result_bytes": {"all-reduce": 64}}


# ------------------------------------------------------------- A5
def test_a5_silent_on_a_clean_step():
    assert sa.check_bf16_upcasts(clean_trace(), 64) == ([], [])
    assert sa.check_dynamic_shapes(clean_trace()) == []


def _upcast(path_storage, shape=(8, 8)):
    return Op("aten._to_copy.default",
              (meta(shape, "bfloat16", storage=path_storage),),
              (meta(shape, "float32", storage=300),))


def test_a5_fires_on_a_param_sized_bf16_upcast():
    t = clean_trace()
    t.ops.append(_upcast(11))
    v, allowed = sa.check_bf16_upcasts(t, 64)
    assert allowed == [] and len(v) == 1
    assert "copies params/layers/0/attn/wq bf16[8, 8] (64 elems ≥ 64)" in v[0]
    t.ops[-1] = _upcast(11, (4, 8))              # below d_model²
    assert sa.check_bf16_upcasts(t, 64) == ([], [])


def test_a5_allow_list_names_its_site_and_reason():
    t = clean_trace(names={11: "params/layers/3/ssm/out_proj"})
    t.ops.append(_upcast(11))
    v, allowed = sa.check_bf16_upcasts(t, 64)
    assert v == [] and allowed == [
        "bf16-upcast: op #3 aten._to_copy.default copies "
        "params/layers/3/ssm/out_proj bf16[8, 8] (64 elems ≥ 64) to float32 "
        "[allowed: ssm/out_proj]"]
    why = dict(sa.ALLOWED_UPCASTS)["ssm/out_proj"]
    assert "models/ssm.py:286" in why and "ROADMAP B'2" in why


@pytest.mark.parametrize("op", [
    Op("aten.nonzero.default", (meta((4,), "bool"),), (meta((2, 1),
                                                            "int64"),)),
    Op("aten.index.Tensor", (meta((4, 8)), meta((4,), "bool")),
       (meta((2, 8)),), bool_index=True),
    Op("aten.repeat_interleave.Tensor", (meta((4,), "int64"),),
       (meta((9,), "int64"),)),
    Op("aten._unique2.default", (meta((4,), "int64"),),
       (meta((3,), "int64"),))],
    ids=["nonzero", "bool-index", "repeat_interleave", "unique"])
def test_a5_fires_on_a_data_dependent_shape(op):
    t = clean_trace()
    t.ops.append(op)
    v = sa.check_dynamic_shapes(t)
    assert len(v) == 1 and v[0].startswith(f"dynamic-shape: op #3 {op.name}")


def test_bucket_static_silent_on_equal_and_fires_on_different_programs():
    a, b = clean_trace(), clean_trace()
    assert sa.check_bucket_static(a, b) == []
    b.ops[0] = Op("aten.mm.default", (meta((4, 8)), meta((8, 8))),
                  (meta((4, 16)),))
    v = sa.check_bucket_static(a, b)
    assert len(v) == 1 and "dispatch different programs (op #0:" in v[0]
    b = clean_trace(launches={"ragged_paged_attention": 2})
    assert "kernel launches" in sa.check_bucket_static(a, b)[0]


def test_sync_async_silent_on_equal_and_fires_on_different_programs():
    a = clean_trace()
    assert sa.check_sync_async(a, clean_trace()) == []
    b = clean_trace()
    b.ops.pop()
    assert sa.check_sync_async(a, b) == [
        "sync-async: the sync-flavoured step dispatches another program "
        "(3 vs 2 ops)"]
    c = clean_trace(collectives={"all-gather": {"count": 1, "bytes": 4}})
    assert sa.check_sync_async(a, c) == [
        "sync-async: the sync-flavoured step runs other collectives"]


# ------------------------------------------------- the real step, CPU
@pytest.fixture(scope="module")
def granite():
    eng = sa.build_engine("granite-3.2-8b", "1x1", device="cpu")
    batches, fetches = sa.capture_serve(eng)
    return eng, batches, fetches


def test_real_audit_granite(granite):
    eng, batches, fetches = granite
    res = sa.settle_golden(sa.audit_engine(
        eng, batches, fetches, eng.runner.call_counts["mixed_step"],
        arch="granite-3.2-8b"))
    assert res.violations == [] and res.fingerprint_diff == "" and res.ok
    assert res.sync_async_identical
    # the reference audit's donated outputs
    assert res.donated == ["k_pool", "tok_buf", "v_pool"]
    assert res.fingerprint == {"counts": {}, "result_bytes": {}}
    assert res.launches == {"ragged_paged_attention": 2,
                            "ragged_grouped_lora_qkv": 2}
    assert 0 < res.memory["alias_size_bytes"]
    assert "temp_size_bytes" not in res.memory
    assert res.to_json()["kind"] == "analysis_audit"


def test_report_renders_the_audit_records(granite, tmp_path, monkeypatch,
                                          capsys):
    from repro_torch.benchmarks import report
    eng, batches, fetches = granite
    res = sa.audit_engine(eng, batches, fetches,
                          eng.runner.call_counts["mixed_step"],
                          arch="granite-3.2-8b")
    (tmp_path / "analysis_audit.jsonl").write_text(
        json.dumps(res.to_json()) + "\n")
    monkeypatch.setattr(report, "BASE", str(tmp_path))
    capsys.readouterr()
    report.main()
    row = next(line for line in capsys.readouterr().out.splitlines()
               if line.startswith("| granite-3.2-8b | 1x1 |"))
    assert "| ok | k_pool, tok_buf, v_pool |" in row and row.endswith("✓ |")


def test_trace_leaves_the_runner_state_alone(granite):
    eng, batches, _ = granite
    r = eng.runner
    before = {n: getattr(r, n).clone() for n in ("k_pool", "v_pool",
                                                 "tok_buf")}
    ptrs = {n: getattr(r, n).data_ptr() for n in before}
    t = r.trace_mixed(sa.richest(batches))
    assert t.pools["k_pool"].version_after > 0
    for n, v in before.items():
        assert getattr(r, n).data_ptr() == ptrs[n]
        assert torch.equal(getattr(r, n), v)


def test_real_step_mutations_are_caught(granite, monkeypatch):
    eng, batches, _ = granite
    mb = sa.richest(batches)
    rms = Lyr.rmsnorm

    def syncing(x, w, eps):
        x.sum().item()
        return rms(x, w, eps)

    monkeypatch.setattr(Lyr, "rmsnorm", syncing)
    assert sa.check_host_roundtrips(eng.runner.trace_mixed(mb))
    monkeypatch.setattr(Lyr, "rmsnorm", rms)
    impl = ModelRunner._mixed_impl

    def rebuilt(self, *a, **k):
        out = impl(self, *a, **k)
        self.tok_buf = self.tok_buf.clone()
        self.params["final_norm"].mul_(1.0)
        return out

    monkeypatch.setattr(ModelRunner, "_mixed_impl", rebuilt)
    v, _ = sa.check_donation(eng.runner.trace_mixed(mb), 2, 0)
    assert any("tok_buf was replaced" in x for x in v)
    assert any("wrote params/final_norm in place" in x for x in v)


@pytest.mark.parametrize("arch,donated,launches", [
    ("mamba2-2.7b", ["live_conv", "live_ssm", "tok_buf"],
     {"ragged_grouped_lora": 2, "ragged_ssd_chunk_scan": 2}),
    ("whisper-large-v3", ["k_pool", "tok_buf", "v_pool"],
     {"ragged_paged_attention": 2, "ragged_grouped_lora_qkv": 2})])
def test_real_audit_ssm_and_encoder_decoder(arch, donated, launches):
    """mamba2 has no K/V pool (no attention layer) and adds the live SSM
    pools; whisper's encoder pools stay untouched by the step."""
    res = sa.audit_config(arch, "1x1", device="cpu")
    assert res.violations == [] and res.ok and res.sync_async_identical
    assert res.donated == donated and res.launches == launches
    assert res.fingerprint["counts"] == {}


def test_bucket_static_across_a_retired_request_on_whisper():
    """Two consecutive decode-only steps of one bucket whose run slots
    differ (a request retired between them, so they span other widths):
    whisper's cross-attention reads the encoder pools over every run
    slot, and both steps dispatch the same program."""
    eng = sa.build_engine("whisper-large-v3", "1x1", device="cpu")
    batches, _ = sa.capture_serve(eng)
    a, b = sa.decode_pair(eng.runner, batches)
    spans = [int(np.ptp(x.run_slots)) + 1 for x in (a, b)]
    assert spans[0] != spans[1]
    ta, tb = (eng.runner.trace_mixed(x) for x in (a, b))
    assert ta.bucket == tb.bucket == eng.runner.buckets(a)
    assert sa.check_bucket_static(ta, tb) == []


def test_capture_counts_its_fetches_across_a_log_trim():
    """The runner's device → host log is trimmed in bulk at
    ``D2H_LOG_MAX`` entries: a capture that crosses the trim still reads
    exactly its own serve's fetches, and the runner's log keeps them."""
    eng = sa.build_engine("granite-3.2-8b", "1x1", device="cpu")
    r = eng.runner
    r.d2h_fetches.extend([(1, "int32", "step")] * (D2H_LOG_MAX - 1))
    steps0 = r.call_counts["mixed_step"]
    _, fetches = sa.capture_serve(eng)
    n_steps = r.call_counts["mixed_step"] - steps0
    assert sa.check_fetches(fetches, n_steps, r.rcfg.max_running) == []
    assert len(r.d2h_fetches) < D2H_LOG_MAX
    assert r.d2h_fetches[-len(fetches):] == fetches


def test_sharded_audit_granite_2x4_matches_its_golden():
    """One world of 8 CPU ranks (gloo); every rank's fingerprint equal."""
    (res,) = sa.audit_all(["granite-3.2-8b"], ["2x4"], device="cpu")
    assert res.violations == [] and res.fingerprint_diff == "" and res.ok
    assert res.donated == ["k_pool", "tok_buf", "v_pool"]
    with open(sa.golden_path("granite-3.2-8b", "2x4")) as f:
        g = json.load(f)
    assert res.fingerprint == {"counts": g["counts"],
                               "result_bytes": g["result_bytes"]}
    assert set(g["counts"]) == {"all-gather", "all-reduce"}


def test_goldens_checked_in_for_every_config_and_mesh():
    for arch in list_archs():
        for mesh in sa.MESHES:
            p = sa.golden_path(arch, mesh)
            assert os.path.exists(p), f"missing golden {p}"
            with open(p) as f:
                g = json.load(f)
            assert g["arch"] == arch and g["mesh"] == mesh
            assert set(g) >= {"counts", "result_bytes"}
            # one device: no collectives, ever; sharded: some
            assert (g["counts"] == {}) == (mesh == "1x1")


# ------------------------------------------------------------- CLI
def test_cli_audit_failure_exit1_and_artifacts(tmp_path, monkeypatch,
                                               capsys):
    from repro_torch.analysis.__main__ import main

    def fake_audit_all(archs, meshes, device=None, update_goldens=False,
                       progress=None):
        bad = sa.AuditResult(arch="granite-3.2-8b", mesh="2x4")
        bad.violations = ["donation: k_pool was replaced by a new tensor"]
        bad.fingerprint_diff = "granite-3.2-8b [2x4]: drift\n"
        return [sa.AuditResult(arch="granite-3.2-8b", mesh="1x1"), bad]

    monkeypatch.setattr(sa, "audit_all", fake_audit_all)
    assert main(["--skip-lint", "--device", "cpu", "--out",
                 str(tmp_path)]) == 1
    err = capsys.readouterr().err
    assert "donation" in err and "drift" in err
    with open(tmp_path / "analysis_audit.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["ok"] for r in recs] == [True, False]
    assert (tmp_path / "analysis_fingerprint_diff.txt").exists()


def test_cli_audit_ok_exit0_removes_a_stale_diff(tmp_path, monkeypatch):
    from repro_torch.analysis.__main__ import main
    (tmp_path / "analysis_fingerprint_diff.txt").write_text("stale\n")
    monkeypatch.setattr(sa, "audit_all", lambda *a, **k: [
        sa.AuditResult(arch="x", mesh="1x1")])
    assert main(["--skip-lint", "--device", "cpu", "--out",
                 str(tmp_path)]) == 0
    assert not (tmp_path / "analysis_fingerprint_diff.txt").exists()


def test_cli_audit_raises_without_a_card(tmp_path, monkeypatch):
    from repro_torch.analysis.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--skip-lint", "--out", str(tmp_path)])
