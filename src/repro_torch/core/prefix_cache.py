"""Cross-model prefix cache over base-aligned block hashes, the
attention half of the reference's ``repro/core/prefix_cache.py``.

An aLoRA request walks its chained block hashes and acquires every
leading block already in the pool, so it matches blocks the base model
prefilled (and vice versa).  The reference's SSM state-snapshot matching
belongs to the SSM slice (ROADMAP A9) and is not ported here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from repro_torch.core.block_hash import (AdapterKey, BlockHash,
                                         request_block_hashes)
from repro_torch.core.kv_manager import BlockManager


@dataclass
class MatchResult:
    n_tokens: int                      # reusable prefix length (tokens)
    kv_blocks: List[int] = field(default_factory=list)


class PrefixCache:
    def __init__(self, *, block_size: int, kv_manager: BlockManager):
        self.block_size = block_size
        self.kv = kv_manager

    def match_and_acquire(self, tokens: Sequence[int],
                          adapter: Optional[AdapterKey],
                          salt: tuple = ()) -> MatchResult:
        """Acquire the longest run of cached leading blocks."""
        hashes = request_block_hashes(tokens, self.block_size, adapter,
                                      salt)
        kv_blocks: List[int] = []
        for h in hashes:
            bid = self.kv.acquire_cached(h)
            if bid is None:
                break
            kv_blocks.append(bid)
        return MatchResult(n_tokens=len(kv_blocks) * self.block_size,
                           kv_blocks=kv_blocks)

    def probe(self, tokens: Sequence[int], adapter: Optional[AdapterKey],
              salt: tuple = ()) -> int:
        """The reusable prefix length ``match_and_acquire`` WOULD return,
        without touching refcounts or the hit/miss counters."""
        depth = 0
        for h in request_block_hashes(tokens, self.block_size, adapter,
                                      salt):
            if self.kv.lookup(h) is None:
                break
            depth += 1
        return depth * self.block_size

    def register_kv_block(self, h: BlockHash, bid: int) -> int:
        """Register a just-filled block; returns the canonical block id."""
        return self.kv.register(bid, h)
