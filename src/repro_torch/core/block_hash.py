"""Base-aligned chained block hashing — the paper's §3 core change.

A copy of the reference's ``repro/core/block_hash.py``: the digests must
be byte-identical to the reference's, because that is what makes prefix
cache hit counts of the two packages comparable.

For Activated LoRA requests, blocks that lie entirely before the
activation point carry K/V equal to the base model's, so the adapter id
is omitted from their hash and they are interchangeable with base-model
blocks.  Post-activation blocks, and every block of a vanilla LoRA
request, keep the adapter id.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

BlockHash = bytes


@dataclass(frozen=True)
class AdapterKey:
    """How a request's adapter affects hashing: ``kind`` is "alora" or
    "lora"; ``inv_start`` the first invocation token's index (aLoRA)."""
    adapter_id: str
    kind: str
    inv_start: int = 0


def hash_block(parent: Optional[BlockHash], tokens: Sequence[int],
               extra: Tuple = ()) -> BlockHash:
    h = hashlib.sha256()
    h.update(parent if parent is not None else b"ROOT")
    h.update(b"|")
    h.update(",".join(map(str, tokens)).encode())
    h.update(b"|")
    h.update(repr(extra).encode())
    return h.digest()[:16]


def block_extra(adapter: Optional[AdapterKey], block_start: int,
                block_end: int) -> Tuple:
    """The ``extra`` identifiers for the block [block_start, block_end):
    () for the base model and for aLoRA blocks entirely before the
    invocation start, (adapter_id,) otherwise."""
    if adapter is None:
        return ()
    if adapter.kind == "lora":
        return (adapter.adapter_id,)
    if adapter.kind != "alora":
        raise ValueError(f"unknown adapter kind {adapter.kind!r}")
    if block_end <= adapter.inv_start:
        return ()
    return (adapter.adapter_id,)


def request_block_hashes(tokens: Sequence[int], block_size: int,
                         adapter: Optional[AdapterKey] = None,
                         salt: Tuple = ()) -> List[BlockHash]:
    """Chained hashes for every FULL block of ``tokens`` (a partial
    trailing block is not hashed); ``salt`` is mixed into every block."""
    out: List[BlockHash] = []
    parent: Optional[BlockHash] = None
    for i in range(len(tokens) // block_size):
        lo, hi = i * block_size, (i + 1) * block_size
        parent = hash_block(parent, tokens[lo:hi],
                            salt + block_extra(adapter, lo, hi))
        out.append(parent)
    return out
