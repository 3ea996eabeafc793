"""Output tokens that reached the host inside the window, of any
request, over the window's seconds."""


def read(rec):
    lo, hi = rec.window
    n = sum(1 for t in rec.requests for s in t.tok_times if lo <= s <= hi)
    return n / (hi - lo)
