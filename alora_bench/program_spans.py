"""Readers of the spans and stamps the engine and runner record
themselves (``repro_torch.obs.tracer.PORT_SPANS``, the ``*_wall``
fields of a request), from a traced run's record: the tracer's events
(``rec.tracer_events``), each counted where its own start lies inside
the window, and the window's requests (``rec.window_requests``).  A
step is a ``submit`` span.  A program that records none of these (an
older checkout) reads as None, never as 0."""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

from alora_bench.stats import percentile


def window_spans(rec, name: str) -> List[Tuple[float, float, Dict[str, Any]]]:
    """``(t0, t1, args)`` of the tracer's ``name`` spans that start in
    the window."""
    lo, hi = rec.window
    return [(t0, t1, args or {}) for kind, _, n, t0, t1, _, args
            in rec.tracer_events
            if kind == "span" and n == name and lo <= t0 < hi]


def per_step(rec, name: str,
             value: Callable[[float, float, Dict[str, Any]], float]
             ) -> Optional[float]:
    """Σ ``value(t0, t1, args)`` over the window's ``name`` spans ÷ the
    window's steps; None without steps, or where the program records no
    ``retire.fetch`` span (it then records none of its phase spans)."""
    steps = len(window_spans(rec, "submit"))
    if not steps or not window_spans(rec, "retire.fetch"):
        return None
    return sum(value(*s) for s in window_spans(rec, name)) / steps


def duration_ms(t0: float, t1: float, args: Dict[str, Any]) -> float:
    return (t1 - t0) * 1e3


def stamp_gap_p95_ms(rec, start: str, end: str) -> Optional[float]:
    """95th percentile over the window's requests of the request's wall
    stamp ``end`` minus ``start`` (ms); a request without ``end`` counts
    as missing (after any finite value).  None where the program stamps
    no request."""
    reqs = [t.req for t in rec.window_requests]
    if not any(getattr(r, "t_submit_wall", None) is not None for r in reqs):
        return None
    xs = []
    for r in reqs:
        a, b = getattr(r, start), getattr(r, end)
        xs.append(math.inf if a is None or b is None else (b - a) * 1e3)
    return percentile(xs, 95)
