"""Request lifecycle (paper Table 2 / Fig. 5), a copy of the reference's
``repro/serving/request.py``.

A request moves through queue → prefill → decode → done; the boundary
timestamps define the paper's metrics:

  queue time   = t_prefill_start - t_arrival
  prefill time = t_decode_start  - t_prefill_start
  decode time  = t_done          - t_decode_start
  TTFT         = queue + prefill
  ITL          = decode / (n_output - 1)
  E2E          = queue + prefill + decode
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np

from repro_torch.core.alora import AdapterSpec
from repro_torch.core.block_hash import AdapterKey, BlockHash


class State(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"


@dataclass
class Request:
    req_id: int
    prompt: List[int]                       # token ids used for hashing
    max_new_tokens: int
    adapter: Optional[AdapterSpec] = None
    # stable registry identity (name#vN) that block hashes salt on —
    # never the slot index, which is recycled across evictions
    adapter_uid: Optional[str] = None
    adapter_slot: int = 0                   # device slot WHILE ADMITTED
    arrival_time: float = 0.0
    prefix_embeds: Optional[np.ndarray] = None   # vlm: (P, d) patch embeds
    frame_embeds: Optional[np.ndarray] = None    # audio: (Se, d) frames
    salt: Tuple = ()                        # cache salt (content digest)
    state: State = State.QUEUED
    t_prefill_start: Optional[float] = None
    t_decode_start: Optional[float] = None
    t_done: Optional[float] = None
    output_tokens: List[int] = field(default_factory=list)
    inv_start: int = 0                      # activation point (aLoRA)
    # bumped on every preemption; rows of an unretired step carry the
    # epoch they were scheduled under and are dropped on mismatch
    epoch: int = 0
    # affinity-window scans in which a younger request was admitted past
    # this one (the starvation cap's counter)
    admission_skips: int = 0
    block_ids: List[int] = field(default_factory=list)
    hashes: List[BlockHash] = field(default_factory=list)  # full-block chain
    n_computed: int = 0                     # tokens with K/V in the cache
    n_cache_hit_tokens: int = 0             # reused via the prefix cache
    run_slot: int = -1                      # tok_buf/live-state slot
    state_reused: bool = False              # SSM snapshot restored
    input_embeds: Any = None                # (S, d) float32 numpy, host

    @property
    def seq_len(self) -> int:
        return len(self.prompt) + len(self.output_tokens)

    @property
    def all_tokens(self) -> List[int]:
        return self.prompt + self.output_tokens

    def adapter_key(self) -> Optional[AdapterKey]:
        if self.adapter is None:
            return None
        return AdapterKey(self.adapter_uid or self.adapter.name,
                          self.adapter.kind, self.inv_start)

    def is_finished(self) -> bool:
        return len(self.output_tokens) >= self.max_new_tokens

    def metrics(self) -> dict:
        if self.state != State.DONE:
            raise RuntimeError(f"request {self.req_id} is not done")
        queue = self.t_prefill_start - self.arrival_time
        prefill = self.t_decode_start - self.t_prefill_start
        decode = self.t_done - self.t_decode_start
        n_out = max(len(self.output_tokens), 1)
        return {
            "req_id": self.req_id,
            "queue": queue,
            "prefill": prefill,
            "decode": decode,
            "ttft": queue + prefill,
            "itl": decode / max(n_out - 1, 1),
            "e2e": queue + prefill + decode,
            "inference": prefill + decode,
            "arrival": self.arrival_time,
            "done": self.t_done,
            "prompt_len": len(self.prompt),
            "output_len": len(self.output_tokens),
            "cache_hit_tokens": self.n_cache_hit_tokens,
            "cache_hit_frac": self.n_cache_hit_tokens
            / max(len(self.prompt), 1),
        }
