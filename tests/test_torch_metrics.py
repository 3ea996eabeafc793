"""The port's ``serving/metrics.py`` against the reference's on the same
per-request dicts: ``aggregate``, ``merge_aggregates`` (union makespan,
staggered windows, n-weighted means, exact percentiles from complete
reservoirs and the fallback without them, empty parts),
``speedup_table``, ``fmt_speedups`` and ``MetricsAggregate.row``, as
cases of ``tests/test_metrics.py``'s scenarios.  Both packages run the
same float64 arithmetic, so every number must agree to float rounding:
relative 1e-12 (NaN equals NaN, infinities equal)."""
import dataclasses
import math

import pytest

from repro.serving import metrics as R
from repro_torch.serving import metrics as T

TOL = 1e-12


def fake_metrics(arrival, done, prompt_len=50, output_len=50, keys=None):
    """One request's metrics dict, as the engine's ``Request.metrics``."""
    e2e = done - arrival
    base = {k: e2e / 4 for k in keys or R.METRIC_KEYS}
    base.update(e2e=e2e, arrival=arrival, done=done,
                prompt_len=prompt_len, output_len=output_len,
                cache_hit_frac=0.0)
    return base


def no_endpoints(recs):
    for r in recs:
        del r["arrival"], r["done"]
    return recs


def hand_built(M):
    """A hand-built aggregate without samples (the fallback merge)."""
    keys = M.METRIC_KEYS
    return M.MetricsAggregate(2, dict.fromkeys(keys, 1.0),
                              dict.fromkeys(keys, 1.0),
                              dict.fromkeys(keys, 1.0), 0.0,
                              total_tokens=100, total_e2e=2.0)


# name -> fn(M) building the scenario's result with module M
SCENARIOS = {
    "aggregate_overlapped": lambda M: M.aggregate(
        [fake_metrics(0.0, 10.0), fake_metrics(0.0, 10.0)]),
    "aggregate_staggered": lambda M: M.aggregate(
        [fake_metrics(0.0, 10.0), fake_metrics(5.0, 20.0)]),
    "aggregate_no_endpoints": lambda M: M.aggregate(
        no_endpoints([fake_metrics(0.0, 10.0)])),
    "aggregate_empty": lambda M: M.aggregate([]),
    "merge_makespan": lambda M: M.merge_aggregates(
        [M.aggregate([fake_metrics(0.0, 10.0)]),
         M.aggregate([fake_metrics(0.0, 10.0)])]),
    "merge_staggered": lambda M: M.merge_aggregates(
        [M.aggregate([fake_metrics(0.0, 10.0)]),
         M.aggregate([fake_metrics(5.0, 20.0)])]),
    "merge_n_weighted_means": lambda M: M.merge_aggregates(
        [M.aggregate([fake_metrics(0.0, 10.0)]),
         M.aggregate([fake_metrics(0.0, 2.0)] * 3)]),
    "merge_single_and_empty": lambda M: M.merge_aggregates(
        [M.aggregate([fake_metrics(0.0, 10.0)]), M.aggregate([])]),
    "merge_all_empty": lambda M: M.merge_aggregates(
        [M.aggregate([]), M.aggregate([])]),
    "merge_exact_percentiles": lambda M: M.merge_aggregates(
        [M.aggregate([fake_metrics(0.0, d) for d in (1.0, 2.0, 3.0)]),
         M.aggregate([fake_metrics(0.0, d)
                      for d in (10.0, 20.0, 30.0, 40.0, 50.0)])]),
    "merge_chained": lambda M: M.merge_aggregates(
        [M.merge_aggregates(
            [M.aggregate([fake_metrics(0.0, d) for d in (1.0, 2.0, 3.0)]),
             M.aggregate([fake_metrics(0.5, d) for d in (10.0, 20.0)])]),
         M.aggregate([fake_metrics(0.0, 100.0)])]),
    "merge_fallback_without_samples": lambda M: M.merge_aggregates(
        [M.aggregate([fake_metrics(0.0, 2.0)] * 2), hand_built(M)]),
    "merge_over_full_reservoir": lambda M: M.merge_aggregates(
        [M.aggregate([fake_metrics(0.0, 1.0 + i % 7)
                      for i in range(M.RESERVOIR_MAX + 5)]),
         M.aggregate([fake_metrics(3.0, 9.0)])]),
    "merge_without_endpoints": lambda M: M.merge_aggregates(
        [M.aggregate(no_endpoints([fake_metrics(0.0, 10.0)])),
         M.aggregate([fake_metrics(0.0, 5.0)])]),
    "row_empty": lambda M: M.aggregate([]).row(),
    "row": lambda M: M.aggregate([fake_metrics(1.0, 4.0)]).row(
        ("e2e", "ttft", "queue")),
    "speedup_empty_baseline": lambda M: M.speedup_table(
        M.aggregate([]), M.aggregate([fake_metrics(0.0, 1.0)])),
    "speedup_true_zero_vs_absent": lambda M: M.speedup_table(
        M.MetricsAggregate(1, {"e2e": 2.0, "ttft": 0.0}, {}, {}, 0.0),
        M.MetricsAggregate(1, {"e2e": 0.0, "ttft": 0.0}, {}, {}, 0.0),
        keys=("e2e", "ttft", "queue")),
    "speedup": lambda M: M.speedup_table(
        M.aggregate([fake_metrics(0.0, 8.0), fake_metrics(1.0, 5.0)]),
        M.aggregate([fake_metrics(0.0, 2.0), fake_metrics(1.0, 2.5)])),
    "fmt_speedups": lambda M: M.fmt_speedups(M.speedup_table(
        M.MetricsAggregate(1, {"e2e": 2.0, "ttft": 0.0}, {}, {}, 0.0),
        M.aggregate([fake_metrics(0.0, 1.0)]))),
}


def plain(x):
    """Aggregates as dicts, recursively, for comparison."""
    if dataclasses.is_dataclass(x):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def assert_close(got, want, path="result"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, (float, int)), path
        if math.isnan(want):
            assert math.isnan(got), path
        else:
            assert math.isclose(got, want, rel_tol=TOL, abs_tol=0.0), \
                (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_metrics_match_reference(name):
    assert_close(plain(SCENARIOS[name](T)), plain(SCENARIOS[name](R)))


def test_constants_and_fields_match_reference():
    assert T.METRIC_KEYS == R.METRIC_KEYS
    assert T.RESERVOIR_MAX == R.RESERVOIR_MAX
    assert [f.name for f in dataclasses.fields(T.MetricsAggregate)] == \
        [f.name for f in dataclasses.fields(R.MetricsAggregate)]
    assert T.AdapterPoolStats(installs=3).row() == \
        R.AdapterPoolStats(installs=3).row()


def test_reservoir_keeps_aggregate_means():
    """The sample reservoir changes nothing ``aggregate`` reported
    before it: means, percentiles and throughputs are those of the
    per-request values; the reservoir holds the first RESERVOIR_MAX."""
    recs = [fake_metrics(0.1 * i, 1.0 + 0.1 * i + i % 5)
            for i in range(T.RESERVOIR_MAX + 3)]
    got = T.aggregate(recs)
    n = len(recs)
    assert math.isclose(got.means["e2e"], sum(r["e2e"] for r in recs) / n,
                        rel_tol=TOL)
    assert got.throughput_tok_per_s == got.total_tokens / (
        max(r["done"] for r in recs) - min(r["arrival"] for r in recs))
    assert got.samples["e2e"] == [r["e2e"] for r in recs][:T.RESERVOIR_MAX]
