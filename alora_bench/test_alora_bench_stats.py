"""The harness's arithmetic on fixed synthetic records: percentiles over
all requests (a missing answer counts past every finite one), rates over
the whole window, the device's idle share and roofline shares from
intervals, and the model FLOPs behind ``step_mfu``; a stall inside the
window moves the tails and the rate."""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import pytest

from alora_bench import profile_read, spec, stats
from alora_bench import yardstick as Y
from alora_bench.draws import Turn
from alora_bench.harness import Record

BENCH = Path(__file__).resolve().parent


class FakeReq:
    def __init__(self, hits=0):
        self.n_cache_hit_tokens = hits
        self.state_reused = False


class Fake:
    """A tracked request: due time, token times, kind, prompt length."""

    def __init__(self, due, toks, kind="base", prompt=100, hits=0,
                 done=True):
        self.due, self.tok_times = due, list(toks)
        self.turn = Turn([0] * prompt, len(toks), None, kind)
        self.prompt_len = prompt
        self.req = FakeReq(hits)
        self.t_done = toks[-1] if done and toks else None

    @property
    def kind(self):
        return self.turn.kind

    @property
    def t_first(self):
        return self.tok_times[0] if self.tok_times else None


def read(name, rec):
    return spec.load_module(BENCH / "metrics" / f"{name}.py").read(rec)


def steady(n=100, stall_at=None, stall=0.0):
    """``n`` requests due every 0.1 s over [0, 10): each gets its first
    token 0.2 s after it is due and then one every 0.05 s, ten tokens;
    a stall of ``stall`` s from ``stall_at`` delays every token after it."""
    reqs = []
    for i in range(n):
        due = 0.1 * i
        toks = [due + 0.2 + 0.05 * k for k in range(10)]
        if stall_at is not None:
            toks = [t + stall if t >= stall_at else t for t in toks]
        reqs.append(Fake(due, toks, kind="eval" if i % 2 else "base",
                         hits=90 if i % 2 else 0))
    return Record(window=(0.0, 10.0), requests=reqs, window_requests=reqs,
                  setup_s=3.0)


def test_percentile_interpolates_and_counts_missing_last():
    assert stats.percentile([1, 2, 3, 4, 5], 50) == 3
    assert stats.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert stats.percentile([1.0] * 96 + [math.inf] * 4, 95) == 1.0
    assert stats.percentile([1.0] * 90 + [math.inf] * 10, 95) == math.inf
    assert np.isclose(stats.percentile(list(np.arange(37.0)), 90),
                      np.percentile(np.arange(37.0), 90))


def test_end_to_end_metrics_on_a_steady_record():
    rec = steady()
    assert read("ttft_p95_ms", rec) == pytest.approx(200.0)
    assert read("eval_ttft_p95_ms", rec) == pytest.approx(200.0)
    assert read("itl_p95_ms", rec) == pytest.approx(50.0)
    # tokens with host times inside [0, 10]: all but the last requests'
    inside = sum(1 for r in rec.requests for t in r.tok_times if t <= 10.0)
    assert read("output_tok_s", rec) == pytest.approx(inside / 10.0)
    assert read("setup_s", rec) == 3.0
    assert read("eval_reuse_pct", rec) == pytest.approx(90.0)


def test_a_stall_moves_the_tails_and_the_rate():
    base, stalled = steady(), steady(stall_at=5.0, stall=2.0)
    assert read("ttft_p95_ms", stalled) > read("ttft_p95_ms", base) + 1000
    assert read("itl_p95_ms", stalled) == pytest.approx(50.0)
    assert read("output_tok_s", stalled) < read("output_tok_s", base)
    gaps = [b - a for r in stalled.requests
            for a, b in zip(r.tok_times, r.tok_times[1:])]
    assert max(gaps) == pytest.approx(2.05)


def test_a_request_that_never_answers_counts_as_missing():
    rec = steady(n=20)
    for r in rec.requests[:2]:
        r.tok_times, r.t_done = [], None
    assert read("ttft_p95_ms", rec) == math.inf


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union_length(iv, 0.0, 5.0) == pytest.approx(3.0)
    assert stats.union_length(iv, 1.5, 3.5) == pytest.approx(1.0)
    assert stats.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]


def profile_record():
    kernels = [("void ns::paged_attention_tile_kernel<float>(Args)", 0.0, 0.2),
               ("void ns::paged_attention_merge_kernel<float>(Args)", 0.2,
                0.25),
               ("nvjet_gemm", 0.3, 0.6), ("Memcpy HtoD (Pinned -> Device)",
                                          0.8, 0.9)]
    p = {"t0": 0.0, "t1": 1.0, "kernels": kernels, "steps": 2}
    calls = [{"t": 0.0, "profiled": True, "b1_bound_s": 0.05},
             {"t": 0.1, "profiled": True, "b1_bound_s": 0.075},
             {"t": 5.0, "profiled": False, "b1_bound_s": 9.0}]
    return Record(profile=p, calls=calls), p


def test_idle_share_roofline_and_breakdown():
    rec, p = profile_record()
    assert profile_read.busy_s(p) == pytest.approx(0.65)
    assert read("device_idle_pct", rec) == pytest.approx(35.0)
    # (0.05 + 0.075) / (0.2 + 0.05)
    assert read("b1_roofline", rec) == pytest.approx(50.0)
    assert read("b3_roofline", rec) is None
    ops = profile_read.top_ops(p)
    assert ops[0] == ["nvjet_gemm", pytest.approx(0.3)]
    assert ops[1][0] == "paged_attention_tile_kernel"
    spans = [("submit", 0.58, 0.85), ("submit.assemble", 0.6, 0.7)]
    gaps = profile_read.idle_gaps(p, spans)
    assert gaps[0] == ["submit.assemble", pytest.approx(0.2)]
    assert gaps[1] == ["harness", pytest.approx(0.1)]


def test_step_mfu_counts_the_model_flops_over_the_window():
    dims = {"d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
            "d_ff": 128, "vocab_size": 100, "activation": "swiglu",
            "kinds": ["attn", "attn"]}
    call = {"t": 1.0, "T": 10, "R": 2, "ctx": 55, "adapted": 4}
    per_tok = 2 * 64 * (64 + 2 * 32) + 2 * 64 * 64 + 2 * 3 * 64 * 128
    lora = 2 * 8 * (64 + 64) + 4 * 8 * (64 + 32)
    want = 10 * 2 * per_tok + 4 * 2 * lora + 2 * 4 * 4 * 16 * 55 \
        + 2 * 2 * 64 * 100
    stack = spec.load_family(BENCH, "stack")
    assert stack.step_flops(call, dims, 8) == want
    rec = Record(window=(0.0, 2.0), calls=[call, dict(call, t=3.0)],
                 dims=dims, family=stack, adapter_rank=8)
    assert read("step_mfu", rec) == pytest.approx(
        100 * want / (2.0 * Y.BF16_PEAK))


def test_schedule_and_assembly_readers():
    ev = [("span", "schedule", "schedule", 1.0, 1.004, 0.0, {}),
          ("span", "schedule", "schedule", 2.0, 2.002, 0.0, {}),
          ("span", "submit", "submit", 2.0, 2.5, 0.0, {}),
          ("span", "schedule", "schedule", 20.0, 21.0, 0.0, {})]
    rec = Record(window=(0.0, 10.0), tracer_events=ev, assembly_s=0.3,
                 mixed_steps=100)
    assert read("schedule_ms", rec) == pytest.approx(3.0)
    assert read("assembly_ms", rec) == pytest.approx(3.0)
