"""``ttft_p95_ms`` over the aLoRA evaluation requests only (host clock,
ms): the latency cross-model reuse decides."""
import math

from alora_bench.stats import percentile


def read(rec):
    xs = [(t.t_first - t.due) * 1e3 if t.t_first is not None else math.inf
          for t in rec.window_requests if t.kind == "eval"]
    return percentile(xs, 95) if xs else None
