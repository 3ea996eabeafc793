"""The readers of the program's own spans and wall stamps
(``program_spans``; ``admit_wait_p95_ms``, ``prefill_p95_ms``,
``fetch_wait_ms``, ``embed_copy_ms``, ``h2d_mb_step``) on hand-built
records with known answers, and on the record of a program that records
none of them, where each reads None."""
from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest

from alora_bench import spec
from alora_bench.harness import Record

BENCH = Path(__file__).resolve().parent
NAMES = ("admit_wait_p95_ms", "prefill_p95_ms", "fetch_wait_ms",
         "embed_copy_ms", "h2d_mb_step")


def read(name, rec):
    return spec.load_module(BENCH / "metrics" / f"{name}.py").read(rec)


def span(name, t0, t1, **args):
    return ("span", "submit", name, t0, t1, 0.0, args)


# three steps in the window (0, 10) and one after it
PHASES = [span("submit", t, t + 0.05) for t in (1.0, 2.0, 3.0, 11.0)]
PORT = [span("retire.fetch", 1.1, 1.105), span("retire.fetch", 2.1, 2.12),
        span("retire.fetch", 3.1, 3.115), span("retire.fetch", 11.1, 12.0),
        span("admit.embed_copy", 1.0, 1.03),
        span("admit.embed_copy", 10.0, 10.5),
        span("submit.upload", 1.01, 1.02, bytes=3_000_000),
        span("submit.upload", 2.01, 2.02, bytes=6_000_000),
        span("submit.upload", 3.01, 3.02, bytes=9_000_000),
        span("submit.upload", 11.01, 11.02, bytes=50_000_000)]


def requests():
    """21 requests: request i waited i ms for admission and prefilled
    10·i ms; the last was never admitted."""
    out = []
    for i in range(21):
        admitted = i < 20
        out.append(SimpleNamespace(req=SimpleNamespace(
            t_submit_wall=5.0, t_admit_wall=5.0 + i / 1e3 if admitted
            else None, t_first_token_wall=5.0 + i / 1e3 + i / 1e2
            if admitted else None)))
    return out


def test_readers_on_a_known_record():
    rec = Record(window=(0.0, 10.0), tracer_events=PHASES + PORT,
                 window_requests=requests())
    assert read("fetch_wait_ms", rec) == pytest.approx((5 + 20 + 15) / 3)
    assert read("embed_copy_ms", rec) == pytest.approx(30 / 3)
    assert read("h2d_mb_step", rec) == pytest.approx(18 / 3)
    # 21 values, the last missing: the 95th percentile is the 20th
    assert read("admit_wait_p95_ms", rec) == pytest.approx(19.0)
    assert read("prefill_p95_ms", rec) == pytest.approx(190.0)


def test_a_request_without_a_first_token_counts_as_missing():
    reqs = requests()[:20]
    for t in reqs[:2]:
        t.req.t_first_token_wall = None
    rec = Record(window=(0.0, 10.0), tracer_events=PHASES + PORT,
                 window_requests=reqs)
    # of 20 values the two highest are missing: p95 lies between them
    assert read("prefill_p95_ms", rec) == float("inf")
    assert read("admit_wait_p95_ms", rec) == pytest.approx(18.05)


def test_a_program_without_the_spans_reads_none():
    """A checkout older than the program's spans: the phase spans only,
    requests without wall stamps."""
    rec = Record(window=(0.0, 10.0), tracer_events=PHASES,
                 window_requests=[SimpleNamespace(req=SimpleNamespace(
                     req_id=i)) for i in range(5)])
    for name in NAMES:
        assert read(name, rec) is None, name
