"""95th percentile over the window's requests of the time from the
first admission to the first token's value on the host (the engine's
wall stamps ``t_admit_wall``, ``t_first_token_wall``; ms): the prefill
chunks, and a preempted request's wait for re-admission.  A request
without a first token counts as missing."""
from alora_bench.program_spans import stamp_gap_p95_ms


def read(rec):
    return stamp_gap_p95_ms(rec, "t_admit_wall", "t_first_token_wall")
