"""Mixed-batch attention over the paged pool — the counterpart of the
reference's ``repro/models/attention.py::ragged_paged_attention``.

Every packed token (decode singletons and prefill-chunk rows alike)
attends over its own request's blocks up to its causal length.  The
step writes the batch's K/V into the pool before this runs, so
intra-chunk causality falls out of the ``q_lens`` mask.  The dispatch
is by device only: a CUDA tensor goes to the hand-written kernel, a CPU
tensor to its plain version (``repro_torch.kernels.paged_attention``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import paged_attention as _kernel


def ragged_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           req_rows: torch.Tensor, q_lens: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """q: (T, H, hd); k_pool/v_pool: (NB, bs, KV, hd); block_tables:
    (R, nb) int32; req_rows, q_lens: (T,) int32.  Returns (T, H, hd)."""
    return _kernel.ragged_paged_attention(q, k_pool, v_pool, block_tables,
                                          req_rows, q_lens, window=window)
