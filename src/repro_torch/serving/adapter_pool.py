"""Dynamic adapter lifecycle — the paged adapter-slot pool, ported from
the reference's ``repro/serving/adapter_pool.py``.

A host registry of arbitrarily many adapters backs a small fixed pool of
device-resident slots (S-LoRA's unified paging).  ``layers`` holds, per
model layer, one preallocated device tensor per leaf: ``(S+1, d, R)``
for A and ``(S+1, R, out)`` for B, slot 0 permanently zero, R the
bucketed slot rank; an attention layer has Q/K/V pairs, an SSM layer
one pair on its fused input projection.  The list and its tensors are
shared with the model runner and written in place, so an install is
visible to the next step.

Per registration: HOST-ONLY → (prefetch) PREFETCHED → (install)
RESIDENT(slot s) → (LRU eviction once unpinned) HOST-ONLY.

* ``prefetch(uid)`` stages the rank-padded host weights on the device.
  On a card the host copy is pinned and the copy runs on a side CUDA
  stream, recorded with an event, so it overlaps the step in flight.
  At most ``staging_budget`` registrations hold a staging copy at once;
  one that no admission claims expires after ``staging_ttl`` ticks.
* ``acquire(uid)`` pins the adapter's slot at admission, installing it
  first if needed (a free slot, or the least recently acquired unpinned
  one).  The install makes the compute stream wait on the staging event
  and copies into the slot in place.  Returns ``None`` when every slot
  is pinned.
* ``release(uid)`` unpins at finish or preemption; the slot stays warm.

Block hashes salt on the registration uid ``name#vN``, never on the slot
or the bare name, so slot reuse cannot alias prefix-cache entries.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.common import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.alora import (
    AdapterSpec,
    adapter_rank_of,
    leaf_shapes,
    pad_adapter_rank,
    per_layer_adapters,
)
from repro_torch.models.layers import dtype_of
from repro_torch.obs.tracer import Tracer
from repro_torch.serving.metrics import AdapterPoolStats

Params = Dict[str, Any]


def rank_bucket(rank: int, lo: int = 8) -> int:
    """Pow2 rank bucket (min ``lo``) — the slot shape ranks pad into."""
    v = lo
    while v < rank:
        v *= 2
    return v


@dataclass
class AdapterRegistration:
    spec: AdapterSpec
    uid: str
    host_layers: List[Params]               # per-layer, rank-padded, host
    device_layers: Optional[List[Params]] = None   # staged on the device
    ready: Optional[torch.cuda.Event] = None       # staging copy done
    slot: Optional[int] = None              # resident slot, if any
    pins: int = 0                           # running requests holding it


class AdapterPool:
    """Fixed device slot pool + host registry (see module docstring)."""

    def __init__(self, cfg: ModelConfig, *, num_slots: int, slot_rank: int,
                 device="cuda", tracer: Optional[Tracer] = None,
                 staging_budget: Optional[int] = None,
                 staging_ttl: int = 64,
                 evict_policy: Optional[
                     Callable[[Sequence[str]], str]] = None):
        if num_slots < 1 or slot_rank < 1 or staging_ttl < 1 \
                or (staging_budget is not None and staging_budget < 1):
            raise ValueError("num_slots, slot_rank, staging_ttl and "
                             "staging_budget must be >= 1")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tracer = tracer if tracer is not None \
            else Tracer(enabled=False)
        self.num_slots = num_slots
        self.slot_rank = slot_rank
        dtype = dtype_of(cfg)
        # one slot stack per leaf of each layer, shaped by its kind
        self.layers: List[Params] = [
            {name: torch.zeros((num_slots + 1,) + shape, dtype=dtype,
                               device=self.device)
             for name, shape in leaf_shapes(cfg, slot_rank, kind).items()}
            for kind in cfg.pattern()]
        # staging copies run here, off the compute stream (card only)
        self._side = torch.cuda.Stream(device=self.device) \
            if self.device.type == "cuda" else None
        self._by_uid: Dict[str, AdapterRegistration] = {}
        self._by_name: Dict[str, str] = {}
        self._versions: Dict[str, int] = {}
        self._free: List[int] = list(range(1, num_slots + 1))
        # residency recency: uid -> None, least-recently-acquired first
        self._lru: "OrderedDict[str, None]" = OrderedDict()
        self.evict_policy = evict_policy
        self.staging_budget = staging_budget if staging_budget is not None \
            else num_slots
        self.staging_ttl = staging_ttl
        # uid -> last-touched tick of every registration holding a stage
        self._staged: "OrderedDict[str, int]" = OrderedDict()
        self._tick = 0
        self.prefetch_issued = 0
        self.prefetch_hits = 0
        self.resident_hits = 0
        self.installs = 0
        self.evictions = 0
        self.acquire_fails = 0
        self.stalled_installs = 0
        self.staged_dropped = 0
        self.prefetch_deferred = 0

    # ------------------------------------------------------------------
    # registry
    # ------------------------------------------------------------------
    def register(self, spec: AdapterSpec, weights: Params) -> str:
        """Register an adapter (segment-stacked ``init_adapter_weights``
        layout, rank ≤ the slot rank); returns its ``uid``."""
        if spec.name in self._by_name:
            raise ValueError(f"adapter {spec.name!r} already registered; "
                             "unregister it first")
        r = adapter_rank_of(weights)
        if r > self.slot_rank:
            raise ValueError(
                f"adapter {spec.name!r} rank {r} exceeds the pool's slot "
                f"rank bucket {self.slot_rank}; construct the engine with "
                f"a larger EngineConfig.adapter_slot_rank")
        ver = self._versions.get(spec.name, 0) + 1
        self._versions[spec.name] = ver
        uid = f"{spec.name}#v{ver}"
        padded = pad_adapter_rank(weights, self.slot_rank)
        pin = self._side is not None
        host = [{k: (v.detach().cpu().pin_memory() if pin
                     else v.detach().cpu().clone())
                 for k, v in lw.items()}
                for lw in per_layer_adapters(self.cfg, padded)]
        self._by_uid[uid] = AdapterRegistration(spec=spec, uid=uid,
                                                host_layers=host)
        self._by_name[spec.name] = uid
        return uid

    def unregister(self, name: str) -> None:
        """Drop a registration; its slot (if resident) frees immediately."""
        uid = self._by_name.get(name)
        if uid is None:
            raise KeyError(name)
        reg = self._by_uid[uid]
        if reg.pins:
            raise RuntimeError(f"adapter {uid} still pinned by "
                               f"{reg.pins} running request(s)")
        if reg.device_layers is not None:
            self._drop_stage(uid, "unregister")
        del self._by_name[name]
        del self._by_uid[uid]
        if reg.slot is not None:
            self._free.append(reg.slot)
            self._lru.pop(uid, None)

    def uid_of(self, name: str) -> str:
        return self._by_name[name]

    def get(self, uid: str) -> AdapterRegistration:
        return self._by_uid[uid]

    @property
    def registered(self) -> List[str]:
        return list(self._by_name)

    # ------------------------------------------------------------------
    # residency
    # ------------------------------------------------------------------
    def prefetch(self, uid: str) -> bool:
        """Stage the weights ahead of admission.  Idempotent: refreshes a
        stage's TTL, a no-op while resident.  Returns ``False`` when the
        staging tier is at its budget and the copy was deferred."""
        reg = self._by_uid[uid]
        if reg.slot is not None:
            return True
        if reg.device_layers is not None:
            self._staged[uid] = self._tick
            self._staged.move_to_end(uid)
            return True
        if len(self._staged) >= self.staging_budget:
            self.prefetch_deferred += 1
            if self.tracer.enabled:
                self.tracer.event("pool", "prefetch_deferred", None,
                                  {"uid": uid})
                self.tracer.count("adapter_prefetch_deferred_total")
            return False
        self._stage(reg)
        self.prefetch_issued += 1
        if self.tracer.enabled:
            self.tracer.event("pool", "prefetch", None, {"uid": uid})
            self.tracer.count("adapter_prefetch_total")
        return True

    def _stage(self, reg: AdapterRegistration) -> None:
        """Copy ``reg``'s host weights to the device.  On a card the copy
        is issued on the side stream from pinned memory and recorded with
        an event; the tensors belong to the side stream's allocator pool
        until the install hands them to the compute stream."""
        if self._side is None:
            reg.device_layers = reg.host_layers
        else:
            with torch.cuda.stream(self._side):
                reg.device_layers = [
                    {k: v.to(self.device, non_blocking=True)
                     for k, v in lw.items()} for lw in reg.host_layers]
                reg.ready = torch.cuda.Event()
                reg.ready.record(self._side)
        self._staged[reg.uid] = self._tick
        self._staged.move_to_end(reg.uid)

    def tick(self) -> None:
        """Advance the staging clock one scheduler step and expire stages
        nothing claimed for ``staging_ttl`` ticks."""
        self._tick += 1
        expired = [uid for uid, touched in self._staged.items()
                   if self._tick - touched > self.staging_ttl]
        for uid in expired:
            self._drop_stage(uid, "expired")

    def drop_unclaimed_stages(self) -> int:
        """Drop every unclaimed staging copy now; returns the count."""
        dropped = list(self._staged)
        for uid in dropped:
            self._drop_stage(uid, "drain")
        return len(dropped)

    def _drop_stage(self, uid: str, reason: str) -> None:
        reg = self._by_uid.get(uid)
        if reg is not None:
            reg.device_layers = None
            reg.ready = None
        self._staged.pop(uid, None)
        self.staged_dropped += 1
        if self.tracer.enabled:
            self.tracer.event("pool", "stage_drop", None,
                              {"uid": uid, "reason": reason})
            self.tracer.count("adapter_staged_dropped_total")

    def acquire(self, uid: str) -> Optional[int]:
        """Pin ``uid``'s slot for a scheduled request, installing it first
        if needed.  Returns the slot, or ``None`` when every slot is
        pinned (the caller queues behind eviction)."""
        reg = self._by_uid[uid]
        if reg.slot is None:
            slot = self._take_slot()
            if slot is None:
                self.acquire_fails += 1
                if self.tracer.enabled:
                    self.tracer.event("pool", "acquire_fail", None,
                                      {"uid": uid})
                    self.tracer.count("adapter_acquire_fails_total")
                return None
            if reg.device_layers is None:
                # never prefetched (or deferred at the budget): stage now,
                # bypassing the budget — the install claims it in-call
                self.stalled_installs += 1
                if self.tracer.enabled:
                    self.tracer.event("pool", "stall", None, {"uid": uid})
                    self.tracer.count("adapter_stalls_total")
                self._stage(reg)
            else:
                self.prefetch_hits += 1
            self._install(reg, slot)
        else:
            self.resident_hits += 1
        reg.pins += 1
        self._lru[uid] = None
        self._lru.move_to_end(uid)
        return reg.slot

    def release(self, uid: str) -> None:
        """Unpin at request finish/preemption; the slot stays warm."""
        reg = self._by_uid[uid]
        if reg.pins <= 0:
            raise RuntimeError(f"release of unpinned adapter {uid}")
        reg.pins -= 1

    def _take_slot(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        candidates = [uid for uid in self._lru
                      if self._by_uid[uid].pins == 0]
        if not candidates:
            return None
        if self.evict_policy is None:
            uid = candidates[0]
        else:
            uid = self.evict_policy(candidates)
            if uid not in candidates:
                raise ValueError(f"evict_policy returned non-candidate "
                                 f"{uid!r}")
        victim = self._by_uid[uid]
        self._lru.pop(uid)
        slot, victim.slot = victim.slot, None
        self.evictions += 1
        if self.tracer.enabled:
            self.tracer.event("pool", "evict", None,
                              {"uid": uid, "slot": slot})
            self.tracer.count("adapter_evictions_total")
        return slot

    def _install(self, reg: AdapterRegistration, slot: int) -> None:
        """Copy the staged weights into ``slot`` in place, on the compute
        stream, after the staging copy has landed.  A step still in
        flight never reads this slot: a token's adapter index only points
        at a slot pinned by its own running request."""
        compute = torch.cuda.current_stream(self.device) \
            if self._side is not None else None
        if reg.ready is not None:
            compute.wait_event(reg.ready)
        for li, lw in enumerate(reg.device_layers):
            for k, w in lw.items():
                self.layers[li][k][slot].copy_(w)
                if compute is not None:
                    # the staged tensor is now read on the compute stream:
                    # keep its memory from reuse until that read is done
                    w.record_stream(compute)
        reg.device_layers = None
        reg.ready = None
        self._staged.pop(reg.uid, None)
        reg.slot = slot
        self.installs += 1
        if self.tracer.enabled:
            self.tracer.event("pool", "install", None,
                              {"uid": reg.uid, "slot": slot})
            self.tracer.count("adapter_installs_total")

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def occupancy(self) -> int:
        return self.num_slots - len(self._free)

    def affinity_of(self, uid: str) -> int:
        """Admission-affinity class: 2 resident, 1 staged, 0 host-only."""
        reg = self._by_uid[uid]
        if reg.slot is not None:
            return 2
        if reg.device_layers is not None:
            return 1
        return 0

    def can_take_slot(self) -> bool:
        """Would an install find a free slot or an unpinned victim now?"""
        return bool(self._free) or any(
            self._by_uid[uid].pins == 0 for uid in self._lru)

    @property
    def staged_now(self) -> int:
        return len(self._staged)

    def stats(self) -> AdapterPoolStats:
        return AdapterPoolStats(
            num_slots=self.num_slots,
            num_registered=len(self._by_name),
            occupancy=self.occupancy,
            prefetch_issued=self.prefetch_issued,
            prefetch_hits=self.prefetch_hits,
            resident_hits=self.resident_hits,
            installs=self.installs,
            evictions=self.evictions,
            acquire_fails=self.acquire_fails,
            stalled_installs=self.stalled_installs,
            staged_now=self.staged_now,
            staged_dropped=self.staged_dropped,
            prefetch_deferred=self.prefetch_deferred,
        )
