"""Bytes a step uploads from the host staging buffers (the ``bytes`` of
the runner's ``submit.upload`` spans) per step of the window (MB, 1e6
bytes)."""
from alora_bench.program_spans import per_step


def read(rec):
    return per_step(rec, "submit.upload", lambda t0, t1, a: a["bytes"] / 1e6)
