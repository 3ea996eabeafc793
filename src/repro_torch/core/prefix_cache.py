"""Cross-model prefix cache: base-aligned block matching and SSM
state-snapshot matching, a copy of the reference's
``repro/core/prefix_cache.py``.

An aLoRA request walks its chained block hashes and acquires every
leading block already in the pool, so it matches blocks the base model
prefilled (and vice versa).  For SSM and hybrid stacks it also matches
state snapshots: the recurrent state at block boundaries, keyed by the
same chained hash.  The deepest boundary with both a snapshot and full
KV-block coverage sets the reuse length; a pure-SSM model has no KV
constraint and an attention-only model no snapshot constraint.
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
    state_slot: Optional[int] = None   # SSM snapshot slot at the boundary


class PrefixCache:
    def __init__(self, *, block_size: int,
                 kv_manager: Optional[BlockManager] = None,
                 state_manager: Optional[BlockManager] = None):
        if kv_manager is None and state_manager is None:
            raise ValueError("a prefix cache needs a KV or a state manager")
        self.block_size = block_size
        self.kv = kv_manager
        self.state = state_manager

    def match_and_acquire(self, tokens: Sequence[int],
                          adapter: Optional[AdapterKey],
                          salt: tuple = ()) -> MatchResult:
        """Acquire the longest usable run of cached leading blocks and,
        with a state manager, the snapshot at its end."""
        hashes = request_block_hashes(tokens, self.block_size, adapter,
                                      salt)
        kv_blocks: List[int] = []
        if self.kv is not None:
            for h in hashes:
                bid = self.kv.acquire_cached(h)
                if bid is None:
                    break
                kv_blocks.append(bid)
            kv_depth = len(kv_blocks)
        else:
            kv_depth = len(hashes)
        # the deepest state snapshot at or below the KV coverage
        state_slot = None
        depth = kv_depth
        if self.state is not None:
            depth = 0
            for i in range(kv_depth, 0, -1):
                if self.state.lookup(hashes[i - 1]) is not None:
                    state_slot = self.state.acquire_cached(hashes[i - 1])
                    depth = i
                    break
        # return the KV blocks acquired beyond the usable boundary
        if self.kv is not None and depth < len(kv_blocks):
            for bid in kv_blocks[depth:]:
                self.kv.release(bid)
            kv_blocks = kv_blocks[:depth]
        return MatchResult(n_tokens=depth * self.block_size,
                           kv_blocks=kv_blocks, state_slot=state_slot)

    def probe(self, tokens: Sequence[int], adapter: Optional[AdapterKey],
              salt: tuple = ()) -> int:
        """The reusable prefix length ``match_and_acquire`` WOULD return,
        without touching refcounts or the hit/miss counters."""
        hashes = request_block_hashes(tokens, self.block_size, adapter,
                                      salt)
        kv_depth = len(hashes)
        if self.kv is not None:
            kv_depth = 0
            for h in hashes:
                if self.kv.lookup(h) is None:
                    break
                kv_depth += 1
        if self.state is None:
            return kv_depth * self.block_size
        for i in range(kv_depth, 0, -1):
            if self.state.lookup(hashes[i - 1]) is not None:
                return i * self.block_size
        return 0

    def register_kv_block(self, h: BlockHash, bid: int) -> int:
        """Register a just-filled block; returns the canonical block id."""
        return self.kv.register(bid, h)

    def register_state(self, h: BlockHash, slot: int) -> int:
        """Register a state snapshot at the boundary hashed ``h``."""
        return self.state.register(slot, h)
