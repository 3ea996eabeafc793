"""95th percentile over the window's requests of the wait from
submission (``Engine.submit``) to the end of the first admission
attempt that succeeds (the engine's wall stamps ``t_submit_wall``,
``t_admit_wall``; ms).  A request never admitted counts as missing."""
from alora_bench.program_spans import stamp_gap_p95_ms


def read(rec):
    return stamp_gap_p95_ms(rec, "t_submit_wall", "t_admit_wall")
