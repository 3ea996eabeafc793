"""Share of the profiled steps' wall time in which no operation ran on
the card (the union of the trace's kernel, copy and set intervals)."""
from alora_bench.profile_read import busy_s


def read(rec):
    p = rec.profile
    if not p:
        return None
    return 100.0 * (1.0 - busy_s(p) / (p["t1"] - p["t0"]))
