"""Paged KV-cache block manager (host-side metadata), a copy of the
reference's ``repro/core/kv_manager.py``.

Physical K/V tensors live in the runner's device pools; this module
manages block identity: allocation, reference counts, the hash → block
prefix index, and LRU reuse of freed blocks that still carry a hash.
A freed block stays in the index until a fresh allocation evicts it,
so a later request with matching hashes revives it (vLLM semantics).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.block_hash import BlockHash


class OutOfBlocks(Exception):
    pass


@dataclass
class BlockMeta:
    ref: int = 0
    hash: Optional[BlockHash] = None


class BlockManager:
    """Identity/refcount/prefix-index manager over a fixed block pool."""

    def __init__(self, num_blocks: int, block_size: int):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.meta: List[BlockMeta] = [BlockMeta() for _ in range(num_blocks)]
        # free blocks in LRU order (least recently freed first)
        self.free: "OrderedDict[int, None]" = OrderedDict(
            (i, None) for i in range(num_blocks))
        self.index: Dict[BlockHash, int] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def num_free(self) -> int:
        return len(self.free)

    def lookup(self, h: BlockHash) -> Optional[int]:
        """Find a cached block by hash WITHOUT acquiring it."""
        return self.index.get(h)

    def acquire_cached(self, h: BlockHash) -> Optional[int]:
        """Acquire the block with hash ``h`` if present (reviving it from
        the free pool); counts a hit or a miss."""
        bid = self.index.get(h)
        if bid is None:
            self.misses += 1
            return None
        self.acquire(bid)
        self.hits += 1
        return bid

    def acquire(self, bid: int) -> int:
        """Ref+1 a specific block by id, reviving it if it was free."""
        if self.meta[bid].ref == 0:
            self.free.pop(bid, None)
        self.meta[bid].ref += 1
        return bid

    def allocate(self) -> int:
        """Allocate a fresh (unhashed) block, evicting the LRU one."""
        if not self.free:
            raise OutOfBlocks("KV-cache pool exhausted")
        bid, _ = self.free.popitem(last=False)
        m = self.meta[bid]
        if m.hash is not None:
            if self.index.get(m.hash) == bid:
                del self.index[m.hash]
            self.evictions += 1
        self.meta[bid] = BlockMeta(ref=1, hash=None)
        return bid

    def register(self, bid: int, h: BlockHash) -> int:
        """Register a fully written block under ``h``; when another block
        already owns the hash, keep that one and return its id."""
        existing = self.index.get(h)
        if existing is not None and existing != bid:
            return existing
        self.index[h] = bid
        self.meta[bid].hash = h
        return bid

    def release(self, bid: int) -> None:
        m = self.meta[bid]
        if m.ref <= 0:
            raise RuntimeError(f"double free of block {bid}")
        m.ref -= 1
        if m.ref == 0:
            self.free[bid] = None

    def release_all(self, bids: List[int]) -> None:
        for b in bids:
            self.release(b)
