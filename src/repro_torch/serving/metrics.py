"""Serving metrics aggregation (paper Table 2), a copy of the
reference's ``repro/serving/metrics.py``: the engine records per-request
stage timings; this module aggregates them per pipeline stage, merges
per-replica aggregates into a fleet's, and renders the paper's LoRA /
aLoRA speedup table."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import numpy as np

METRIC_KEYS = ("queue", "prefill", "decode", "ttft", "itl", "e2e",
               "inference", "cache_hit_frac")

# Per-metric sample reservoir bound carried on each aggregate so that
# ``merge_aggregates`` can recompute fleet percentiles EXACTLY from the
# union of per-request values instead of n-weighting per-part
# percentiles.  Deterministic first-N (not random sampling): benchmark
# runs are replayable and goldens must not wobble.  Exactness holds
# while every merged part carries a COMPLETE reservoir, i.e. each
# part's n ≤ RESERVOIR_MAX; beyond that the merge falls back to the
# n-weighted approximation.
RESERVOIR_MAX = 1024


@dataclass
class MetricsAggregate:
    n: int
    means: Dict[str, float]
    p50: Dict[str, float]
    p99: Dict[str, float]
    # tokens / makespan (max done − min arrival): the system's actual
    # wall-clock throughput under concurrency
    throughput_tok_per_s: float
    # tokens / Σ per-request e2e: a PER-REQUEST service rate (summing
    # overlapped request lifetimes double-counts wall-clock, so this is
    # not the system's throughput)
    tok_per_req_s: float = 0.0
    # extensive totals + wall-clock endpoints, kept so aggregates MERGE
    # without double-counting overlapped wall-clock: the multi-replica
    # router's replicas run concurrently, so fleet throughput is
    # Σ tokens / (max done − min arrival) over the union — NEVER a sum
    # (or mean) of per-replica throughputs, which would count the same
    # wall-clock interval once per replica.  NaN endpoints mean the
    # source metrics carried no arrival/done timestamps.
    total_tokens: int = 0
    total_e2e: float = 0.0
    t_min_arrival: float = float("nan")
    t_max_done: float = float("nan")
    # per-metric raw-value reservoir (first RESERVOIR_MAX per-request
    # values, deterministic) enabling exact percentile merges; None on
    # hand-built aggregates and on merges whose union outgrew the bound
    samples: Optional[Dict[str, List[float]]] = None

    def row(self, keys: Iterable[str] = METRIC_KEYS) -> Dict[str, float]:
        """Means per metric key; an empty aggregate yields NaNs (never a
        KeyError — renderers show them as ``-``)."""
        return {k: self.means.get(k, float("nan")) for k in keys}


def aggregate(metrics: List[dict]) -> MetricsAggregate:
    if not metrics:
        return MetricsAggregate(0, {}, {}, {}, 0.0)
    means, p50, p99 = {}, {}, {}
    samples: Dict[str, List[float]] = {}
    for k in METRIC_KEYS:
        vals = np.array([m[k] for m in metrics], dtype=np.float64)
        means[k] = float(vals.mean())
        p50[k] = float(np.percentile(vals, 50))
        p99[k] = float(np.percentile(vals, 99))
        samples[k] = [float(v) for v in vals[:RESERVOIR_MAX]]
    total_tokens = sum(m["prompt_len"] + m["output_len"] for m in metrics)
    total_e2e = sum(m["e2e"] for m in metrics)
    tok_per_req = total_tokens / total_e2e if total_e2e else 0.0
    # wall-clock throughput over the batch's makespan; requests recorded
    # without endpoints (hand-built dicts) fall back to the per-request
    # rate rather than inventing a wall-clock
    t_lo = t_hi = float("nan")
    if all(m.get("arrival") is not None and m.get("done") is not None
           for m in metrics):
        t_lo = min(m["arrival"] for m in metrics)
        t_hi = max(m["done"] for m in metrics)
        makespan = t_hi - t_lo
        throughput = total_tokens / makespan if makespan > 0 \
            else tok_per_req
    else:
        throughput = tok_per_req
    return MetricsAggregate(
        n=len(metrics), means=means, p50=p50, p99=p99,
        throughput_tok_per_s=throughput, tok_per_req_s=tok_per_req,
        total_tokens=total_tokens, total_e2e=total_e2e,
        t_min_arrival=t_lo, t_max_done=t_hi, samples=samples)


def merge_aggregates(parts: List[MetricsAggregate]) -> MetricsAggregate:
    """Merge per-replica aggregates into one fleet aggregate.

    Replicas run CONCURRENTLY, so the fleet's wall-clock throughput is
    the union's Σ tokens over the union's makespan (earliest arrival →
    latest done across every part) — summing or averaging per-replica
    throughputs would count overlapped wall-clock once per replica and
    overstate the fleet rate.  Means merge exactly (n-weighted).
    Percentiles merge EXACTLY from the per-part sample reservoirs
    whenever every part carries a complete one (each part's n ≤
    RESERVOIR_MAX — comfortably true for every run this repo performs);
    only when a part has reduced away its raw values (hand-built
    aggregates, or a part that outgrew its reservoir) does the merge
    fall back to the n-weighted mean of per-part percentiles, an approximation that is exact only when the parts
    are identically distributed.  The merged aggregate keeps the
    concatenated samples while they still fit the bound, so chained
    merges (fleet-of-fleets) stay exact too.
    """
    parts = [p for p in parts if p.n]
    if not parts:
        return MetricsAggregate(0, {}, {}, {}, 0.0)
    if len(parts) == 1:
        return parts[0]
    n = sum(p.n for p in parts)

    def wmean(dicts: List[Dict[str, float]]) -> Dict[str, float]:
        keys = set().union(*dicts)
        return {k: sum(d.get(k, 0.0) * p.n for d, p in zip(dicts, parts))
                / n for k in keys}

    # Exact percentile path: every part still carries its complete raw
    # values (len == n for every metric key), so the union's
    # percentiles are computed from the concatenation, not
    # approximated.  Any incomplete part downgrades the whole merge.
    exact = all(
        p.samples is not None
        and all(len(p.samples.get(k, ())) == p.n for k in METRIC_KEYS)
        for p in parts)
    p50: Dict[str, float] = {}
    p99: Dict[str, float] = {}
    merged_samples: Optional[Dict[str, List[float]]] = None
    if exact:
        pooled = {k: [v for p in parts for v in p.samples[k]]  # type: ignore[index]
                  for k in METRIC_KEYS}
        for k, vals in pooled.items():
            arr = np.asarray(vals, dtype=np.float64)
            p50[k] = float(np.percentile(arr, 50))
            p99[k] = float(np.percentile(arr, 99))
        if n <= RESERVOIR_MAX:
            merged_samples = pooled
    else:
        p50 = wmean([p.p50 for p in parts])
        p99 = wmean([p.p99 for p in parts])

    total_tokens = sum(p.total_tokens for p in parts)
    total_e2e = sum(p.total_e2e for p in parts)
    tok_per_req = total_tokens / total_e2e if total_e2e else 0.0
    arrivals = [p.t_min_arrival for p in parts]
    dones = [p.t_max_done for p in parts]
    t_lo = t_hi = float("nan")
    if not any(np.isnan(arrivals)) and not any(np.isnan(dones)):
        t_lo, t_hi = min(arrivals), max(dones)
        makespan = t_hi - t_lo
        throughput = total_tokens / makespan if makespan > 0 \
            else tok_per_req
    else:
        throughput = tok_per_req
    return MetricsAggregate(
        n=n,
        means=wmean([p.means for p in parts]),
        p50=p50, p99=p99,
        throughput_tok_per_s=throughput, tok_per_req_s=tok_per_req,
        total_tokens=total_tokens, total_e2e=total_e2e,
        t_min_arrival=t_lo, t_max_done=t_hi, samples=merged_samples)


@dataclass
class AdapterPoolStats:
    """Adapter-lifecycle counters (the Prometheus-gauge equivalents for
    the dynamic adapter pool): how often weights moved, how full the
    slot pool ran, and whether admission ever stalled on weights."""
    num_slots: int = 0
    num_registered: int = 0
    occupancy: int = 0            # resident slots right now
    prefetch_issued: int = 0      # async H2D transfers started
    prefetch_hits: int = 0        # installs that found staged weights
    resident_hits: int = 0        # acquire found the slot warm
    installs: int = 0             # slot writes (scatter into the stack)
    evictions: int = 0            # LRU slot reclaims
    acquire_fails: int = 0        # admissions queued behind eviction
    stalled_installs: int = 0     # installs whose H2D was never prefetched
    staged_now: int = 0           # staging copies on device right now
    staged_dropped: int = 0       # stages expired/unregistered unclaimed
    prefetch_deferred: int = 0    # prefetches refused at the staging budget

    def row(self) -> Dict[str, float]:
        return {k: float(getattr(self, k)) for k in (
            "num_slots", "num_registered", "occupancy", "prefetch_issued",
            "prefetch_hits", "resident_hits", "installs", "evictions",
            "acquire_fails", "stalled_installs", "staged_now",
            "staged_dropped", "prefetch_deferred")}


def speedup_table(baseline: MetricsAggregate, ours: MetricsAggregate,
                  keys: Iterable[str] = ("e2e", "ttft", "queue", "prefill",
                                         "decode")) -> Dict[str, float]:
    """Paper-style speedup factors (baseline=LoRA / ours=aLoRA).

    A stage ABSENT from either side (the aggregate never saw it — empty
    stage, or a hand-built aggregate without the key) yields NaN, which
    ``fmt_speedups`` renders as ``-``.  ``inf`` is reserved for a TRUE
    measured zero in ours against a positive baseline (the stage really
    took no time); a 0/0 stage is a 1.0 no-op, not an infinite speedup.
    """
    out = {}
    for k in keys:
        b = baseline.means.get(k, float("nan"))
        o = ours.means.get(k, float("nan"))
        if math.isnan(b) or math.isnan(o):
            out[k] = float("nan")           # stage absent → render "-"
        elif o == 0.0:
            out[k] = float("inf") if b > 0 else 1.0
        else:
            out[k] = b / o
    return out


def fmt_speedups(sp: Dict[str, float]) -> str:
    """Render a ``speedup_table`` dict for CSV notes / stdout: absent
    stages (NaN) show as ``-`` instead of ``nanx``."""
    return " ".join(
        f"{k}=-" if math.isnan(v) else f"{k}={v:.2f}x"
        for k, v in sp.items())
