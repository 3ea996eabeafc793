"""Activation-aware masking — paper Alg. 1, a copy of the reference's
``repro/core/activation_mask.py``.

The mask and the choice of adapter merge into one per-token adapter
index: 0 selects the zero adapter (base-model tokens AND pre-activation
tokens of an aLoRA request), slot i > 0 selects adapter i.  Host-side
numpy, run while the engine assembles a batch.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def find_invocation_start(tokens: Sequence[int],
                          invocation_tokens: Sequence[int]) -> Optional[int]:
    """Index of the first token of the LAST occurrence of the invocation
    sequence in ``tokens`` (None if absent)."""
    inv = list(invocation_tokens)
    if not inv:
        return None
    toks = list(tokens)
    n, m = len(toks), len(inv)
    for start in range(n - m, -1, -1):
        if toks[start:start + m] == inv:
            return start
    return None


def adapter_index_for_positions(positions: np.ndarray, slot: int,
                                kind: Optional[str],
                                inv_start: int) -> np.ndarray:
    """Per-token adapter index for one request: vanilla "lora" applies
    everywhere, "alora" only at positions >= inv_start."""
    positions = np.asarray(positions)
    if slot == 0 or kind is None:
        return np.zeros_like(positions, dtype=np.int32)
    if kind == "lora":
        return np.full_like(positions, slot, dtype=np.int32)
    if kind != "alora":
        raise ValueError(f"unknown adapter kind {kind!r}")
    return np.where(positions >= inv_start, slot, 0).astype(np.int32)
