"""Serving metrics aggregation (paper Table 2), a copy of the per-engine
part of the reference's ``repro/serving/metrics.py``: per-request stage
timings aggregated per pipeline stage, and the adapter-pool counters.
(The fleet merge, ``merge_aggregates``, comes with the router.)"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

METRIC_KEYS = ("queue", "prefill", "decode", "ttft", "itl", "e2e",
               "inference", "cache_hit_frac")


@dataclass
class MetricsAggregate:
    n: int
    means: Dict[str, float]
    p50: Dict[str, float]
    p99: Dict[str, float]
    # tokens / makespan (max done − min arrival)
    throughput_tok_per_s: float
    # tokens / Σ per-request e2e: a per-request service rate
    tok_per_req_s: float = 0.0
    total_tokens: int = 0
    total_e2e: float = 0.0
    t_min_arrival: float = float("nan")
    t_max_done: float = float("nan")


def aggregate(metrics: List[dict]) -> MetricsAggregate:
    if not metrics:
        return MetricsAggregate(0, {}, {}, {}, 0.0)
    means, p50, p99 = {}, {}, {}
    for k in METRIC_KEYS:
        vals = np.array([m[k] for m in metrics], dtype=np.float64)
        means[k] = float(vals.mean())
        p50[k] = float(np.percentile(vals, 50))
        p99[k] = float(np.percentile(vals, 99))
    total_tokens = sum(m["prompt_len"] + m["output_len"] for m in metrics)
    total_e2e = sum(m["e2e"] for m in metrics)
    tok_per_req = total_tokens / total_e2e if total_e2e else 0.0
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
        t_min_arrival=t_lo, t_max_done=t_hi)


@dataclass
class AdapterPoolStats:
    """Adapter-lifecycle counters of the adapter-slot pool."""
    num_slots: int = 0
    num_registered: int = 0
    occupancy: int = 0            # resident slots right now
    prefetch_issued: int = 0      # H2D staging copies started
    prefetch_hits: int = 0        # installs that found staged weights
    resident_hits: int = 0        # acquire found the slot warm
    installs: int = 0             # slot writes
    evictions: int = 0            # LRU slot reclaims
    acquire_fails: int = 0        # admissions queued behind eviction
    stalled_installs: int = 0     # installs whose H2D was never prefetched
    staged_now: int = 0           # staging copies on device right now
    staged_dropped: int = 0       # stages expired/unregistered unclaimed
    prefetch_deferred: int = 0    # prefetches refused at the staging budget
