"""Readings of the traced run's profiler window: device busy time, a
kernel's roofline share, the operations that took most time and the
longest idle gaps named by what the host was doing."""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

from alora_bench.stats import gaps, union_length

HARNESS = "harness"        # host time outside every wrapped span


def busy_s(p: Dict[str, Any]) -> float:
    return union_length(((a, b) for _, a, b in p["kernels"]), p["t0"],
                        p["t1"])


def kernel_s(p: Dict[str, Any], names: Sequence[str]) -> float:
    return sum(min(b, p["t1"]) - max(a, p["t0"]) for n, a, b in p["kernels"]
               if any(k in n for k in names) and b > p["t0"] and a < p["t1"])


def roofline(rec, key: str, names: Sequence[str]) -> Optional[float]:
    """Σ least time of the profiled calls over Σ device time of the
    kernels ``names`` in the profiled window (%); None when the window
    ran none of them."""
    p = rec.profile
    if not p:
        return None
    t = kernel_s(p, names)
    bound = sum(c.get(key, 0.0) for c in rec.calls if c["profiled"])
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t


def short_name(name: str, n: int = 96) -> str:
    """A kernel's name without its namespaces, template arguments and
    parameters."""
    if name.startswith(("Memcpy", "Memset")):
        return name[:n]
    base = name.replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in base:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    base = "".join(out).replace("void ", "").strip()
    parts = base.split("::")
    short = parts[-1] if len(parts[-1]) > 8 else "::".join(parts[-2:])
    if short.startswith("cutlass::Kernel") and "<" in name:
        # a CUTLASS kernel is named by its first template argument
        short += "<" + name.split("<", 1)[1].split(",")[0].split(">")[0] + ">"
    return short[:n] or name[:n]


def top_ops(p: Dict[str, Any], k: int = 10) -> List[List]:
    by: Dict[str, float] = defaultdict(float)
    for n, a, b in p["kernels"]:
        by[short_name(n)] += b - a
    return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]


def host_label(spans: List[Tuple[str, float, float]], t: float) -> str:
    """The innermost host span holding time ``t``."""
    best, length = HARNESS, float("inf")
    for name, a, b in spans:
        if a <= t <= b and b - a < length:
            best, length = name, b - a
    return best


def idle_gaps(p: Dict[str, Any], spans, k: int = 10) -> List[List]:
    g = gaps(((a, b) for _, a, b in p["kernels"]), p["t0"], p["t1"])
    g.sort(key=lambda ab: ab[0] - ab[1])
    return [[host_label(spans, (a + b) / 2), b - a] for a, b in g[:k]]
