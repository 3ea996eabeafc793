"""Host time a step waits for its sampled ids (the runner's
``retire.fetch`` span, the one per-step device-to-host sync) per step
of the window (ms)."""
from alora_bench.program_spans import duration_ms, per_step


def read(rec):
    return per_step(rec, "retire.fetch", duration_ms)
