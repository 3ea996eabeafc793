"""95th percentile, over every request due in the window, of first
token time minus due time (host clock, ms); a request that never
produced a token counts as missing."""
import math

from alora_bench.stats import percentile


def read(rec):
    xs = [(t.t_first - t.due) * 1e3 if t.t_first is not None else math.inf
          for t in rec.window_requests]
    return percentile(xs, 95) if xs else None
