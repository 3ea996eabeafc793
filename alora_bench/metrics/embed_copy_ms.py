"""Host time admissions spend copying prompt embeddings to the host (the
engine's ``admit.embed_copy`` span around
``ModelRunner.build_input_embeds``, whose copy waits for the step in
flight) per step of the window (ms)."""
from alora_bench.program_spans import duration_ms, per_step


def read(rec):
    return per_step(rec, "admit.embed_copy", duration_ms)
