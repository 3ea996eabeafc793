"""Model FLOPs of the tokens the mixed steps of the window computed
(prefill tokens not served from the cache, and decode tokens: every
layer's products, the adapters' deltas on adapted tokens, attention
over each token's context, the SSM scan, the logits; counted by the
configuration's model family) over the window's seconds at the card's
bf16 peak, 989 TFLOP/s (%)."""
from alora_bench import yardstick as Y


def read(rec):
    lo, hi = rec.window
    calls = [c for c in rec.calls if lo <= c["t"] < hi]
    if not calls:
        return None
    flops = sum(rec.family.step_flops(c, rec.dims, rec.adapter_rank)
                for c in calls)
    return 100.0 * flops / ((hi - lo) * Y.BF16_PEAK)
