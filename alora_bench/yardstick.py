"""The benchmark's yardstick: the card's peaks, the least bytes and
operations of the two serving kernels a roofline share is taken
against.  The model FLOPs of a mixed step depend on the model, and are
its family's (``families/<family>.py::step_flops``).

Frozen here so that a later change to the program cannot move it.  The
byte and operation counts of B1 (ragged paged attention) and B3 (the
ragged SSD scan) follow ``repro_torch/kernels/bench.py``'s
``attention_case`` and ``ssd_ops``/``ssd_case``, which count each input
byte read once and each output byte written once; a test holds the
copies here equal to the originals at serving shapes.  Nothing here
imports the program.
"""
from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates, at the card's 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_PEAK = 989e12
# float32 kernels of the port run on the tensor cores as three TF32
# products (3xTF32), so their bound is TF32's 495 TFLOP/s over three
FP32_TENSOR_PEAK = 495e12 / 3
PEAK_OPS = {"bfloat16": BF16_PEAK, "float32": FP32_TENSOR_PEAK}
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(nbytes: float, ops: float, dtype: str) -> float:
    """The least time the card takes for ``nbytes`` and ``ops``: the
    larger of the bytes' time at HBM bandwidth and the operations' at
    the type's peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype])


# ---------------------------------------------------------------------------
# B1: paged attention
# ---------------------------------------------------------------------------
def decode_attention_work(*, B: int, H: int, KV: int, hd: int, bs: int,
                          nb: int, lengths: Sequence[int], window: int,
                          es: int):
    """(bytes, operations) of decode attention, one query per sequence
    over ``lengths[b]`` tokens of a (B, nb) table: the count of
    ``kernels/bench.py``'s ``attention_case``."""
    blocks = ops = 0
    for n in lengths:
        first = max(0, n - window) // bs if window else 0
        blocks += -(-n // bs) - first
        ops += 4 * H * hd * (min(n, window) if window else n)
    nbytes = 2 * B * H * hd * es + 2 * blocks * bs * KV * hd * es \
        + 4 * (B * nb + B)
    return nbytes, ops


def ragged_attention_work(*, H: int, KV: int, hd: int, bs: int,
                          q_lens: np.ndarray, req_rows: np.ndarray,
                          block_tables: Sequence[Sequence[int]],
                          table_width: int, es: int):
    """(bytes, operations) of one ragged paged attention call without a
    window: every packed row reads the K/V of its request's positions
    below its ``q_lens`` (position + 1).  Bytes: q in and out once, each
    distinct K/V block that some row reads once (requests that share a
    cached block read it once), the (R, table_width) table and the two
    int32 index vectors; operations: Q.K^T and P.V over each row's
    positions.  With one row per request it is
    :func:`decode_attention_work` plus the ``req_rows`` vector."""
    q_lens = np.asarray(q_lens, dtype=np.int64)
    req_rows = np.asarray(req_rows, dtype=np.int64)
    T = int(q_lens.shape[0])
    R = len(block_tables)
    ops = 4 * H * hd * int(q_lens.sum())
    most = np.zeros(R, dtype=np.int64)
    np.maximum.at(most, req_rows, q_lens)
    used = [np.asarray(t[:-(-int(n) // bs)]) for t, n in
            zip(block_tables, most)]
    blocks = int(np.unique(np.concatenate(used)).size) if used else 0
    nbytes = 2 * T * H * hd * es + 2 * blocks * bs * KV * hd * es \
        + 4 * (R * table_width + 2 * T)
    return nbytes, ops


# ---------------------------------------------------------------------------
# B3: the SSD scan
# ---------------------------------------------------------------------------
def ssd_ops(S: int, N: int, P: int, from_zero: bool = True) -> int:
    """The least operations the scan of one (row, head) over S tokens
    needs: those of the chunked form at its best chunk length (a chunk
    of q tokens costs the lower triangles of C.B^T and W.x, C.state and
    the state update, and the state's decay).  ``from_zero``: the first
    chunk starts from a zero state and needs neither C.state nor the
    decay (``kernels/bench.py``'s ``ssd_ops``); a segment that continues
    a request's state needs both in every chunk."""
    def chunk(q, first):
        return q * (q + 1) * (N + P) + 2 * q * N * P \
            + (0 if first else 2 * q * N * P + N * P)

    def at(Q):
        full, rest = divmod(S, Q)
        return chunk(Q, from_zero) + (full - 1) * chunk(Q, False) \
            + (chunk(rest, False) if rest else 0)
    return min(at(Q) for Q in range(1, S + 1))


def dense_ssd_bytes(*, Bt: int, S: int, H: int, N: int, P: int) -> int:
    """Bytes of the dense scan over (Bt, S) from zero states: x and y, B
    and C, dA and dt, the final states (``kernels/bench.py``'s
    ``ssd_case``)."""
    return 4 * (2 * Bt * S * H * P + 2 * Bt * S * H * N + 2 * Bt * S * H
                + Bt * H * N * P)


def ragged_ssd_work(*, H: int, N: int, P: int, seg_lens: Iterable[int],
                    seg_from_zero: Iterable[bool], n_kept: int):
    """(bytes, operations) of one ragged scan call (float32) over
    segments of ``seg_lens`` tokens: x and y, B and C, dA and dt per
    token, each segment's entry state read, the ``n_kept`` states it
    returns (each request's last token and the snapshot rows) written,
    and its int32 vectors (segment starts and slots per token, the kept
    rows).  A segment whose request starts at position 0 from a reset
    state needs the zero-state count of :func:`ssd_ops`."""
    lens = list(seg_lens)
    zeros = list(seg_from_zero)
    T, R = sum(lens), len(lens)
    ops = sum(H * ssd_ops(n, N, P, z) for n, z in zip(lens, zeros))
    nbytes = 4 * (2 * T * H * P + 2 * T * H * N + 2 * T * H) \
        + 4 * (R + n_kept) * H * N * P + 4 * (2 * T + n_kept)
    return nbytes, ops
