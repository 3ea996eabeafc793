"""Mean per step of the engine tracer's ``schedule`` span (decode
claims, admission with prefix-cache matching, prefill chunking) over
the steps of the window (host clock, ms)."""


def read(rec):
    lo, hi = rec.window
    xs = [t1 - t0 for kind, _, name, t0, t1, *_ in rec.tracer_events
          if kind == "span" and name == "schedule" and lo <= t0 < hi]
    return sum(xs) / len(xs) * 1e3 if xs else None
