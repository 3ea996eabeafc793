"""95th percentile over every gap between consecutive output tokens of
every request due in the window (host clock, ms)."""
import numpy as np

from alora_bench.stats import percentile


def read(rec):
    xs = []
    for t in rec.window_requests:
        if len(t.tok_times) > 1:
            xs.extend((np.diff(t.tok_times) * 1e3).tolist())
    return percentile(xs, 95) if xs else None
