"""Multi-replica serving tier: a cache-affinity router over N engines, a
copy of the reference's ``repro/serving/router.py``.

``Router`` fronts N in-process :class:`Engine` replicas — each with its
own device pools, prefix cache and adapter slots — and places every
submission with an aLoRA-aligned locality score instead of blind load
balancing.

Placement (``policy="affinity"``) ranks replicas by

1. **cached-prefix depth** — ``Engine.cached_prefix_tokens``, the same
   chained base-aligned block hashes admission matches on
   (``core.block_hash``, adapter-uid-salted).  Because hashing is
   base-aligned, an aLoRA turn scores hits against blocks a sibling
   adapter or the base model prefilled on that replica — the paper's
   cross-model reuse, lifted to the placement decision;
2. **adapter residency** — a replica with the request's adapter already
   installed in a device slot skips the eviction+install charge;
3. **least outstanding tokens** — remaining prompt+decode work, so cold
   requests spread across the fleet.

Ties break toward the lowest replica index (deterministic placement:
an R-replica fleet is token-for-token reproducible against a
single engine).

Multi-turn pipelines additionally pass ``session=``: the first turn
pins the session to its scored replica and later turns follow the pin.
``policy="round_robin"`` ignores all signals (the A/B baseline).

``stop_replica`` drains a replica without losing work: not-yet-admitted
requests re-route to the surviving replicas (original arrival times
kept), admitted ones finish on the draining replica — the router keeps
stepping it until it empties, then stops placing on it.

The router is host-side Python over the replica surface only — no
device work of its own, every probe non-acquiring.  The replicas may
share one set of weights on the card (``ModelRunner`` keeps tensors
already on its device as they are).  Fleet aggregation goes through
``serving.metrics.merge_aggregates`` (overlapped wall-clock is counted
once via min-arrival/max-done endpoints, never summed).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.alora import AdapterSpec
from repro_torch.obs.tracer import Tracer
from repro_torch.serving.engine import Engine
from repro_torch.serving.metrics import MetricsAggregate, merge_aggregates
from repro_torch.serving.request import Request

POLICIES = ("affinity", "round_robin")


@dataclass(frozen=True)
class Placement:
    """One admission decision (``Router.placements`` keeps the log)."""
    req_id: int                     # router-global request id
    replica: int
    cached_tokens: int              # scored prefix depth at placement
    adapter_resident: bool
    via_session: bool               # pinned by a sticky session


class Router:
    """Cache-affinity admission router over in-process engine replicas.

    All replicas must be built from the same config/params (the fleet is
    a data-parallel scale-out of one model); adapters are registered
    THROUGH the router so every replica assigns the same registry uid —
    the uid salts block hashes, so uid agreement is what keeps a
    session's prefix chain portable across replicas.
    """

    def __init__(self, replicas: Sequence[Engine], *,
                 policy: str = "affinity"):
        if not replicas:
            raise ValueError("router needs at least one replica")
        if policy not in POLICIES:
            raise ValueError(
                f"unknown routing policy {policy!r}: expected one of "
                f"{POLICIES}")
        self.replicas: List[Engine] = list(replicas)
        self.policy = policy
        # fleet tracing: stamp each replica's tracer with its fleet
        # position (per-replica Perfetto tracks) and keep a router-own
        # tracer (replica=-1 → the "router" process) for placement
        # decisions; export via repro_torch.obs.export over
        # [*(eng.tracer for eng in replicas), router.tracer]
        self.tracer = Tracer(replica=-1)
        for i, eng in enumerate(self.replicas):
            eng.tracer.set_replica(i)
        self._stopped = [False] * len(self.replicas)
        self._rr_next = 0
        self._next_id = 0
        # router-global req id -> (replica index, replica-local req id)
        self._routes: Dict[int, Tuple[int, int]] = {}
        self._sessions: Dict[Hashable, int] = {}
        self.placements: List[Placement] = []
        self.reroutes = 0               # drain-time resubmissions

    # ------------------------------------------------------------------
    # adapter lifecycle: fleet-wide, uid-aligned
    # ------------------------------------------------------------------
    def register_adapter(self, spec: AdapterSpec, weights) -> str:
        """Register on EVERY replica; returns the (shared) registry uid.

        Registration is fleet-wide even on stopped replicas so a later
        restart never desynchronizes the uid counters; the uids must
        agree because block hashes salt on them — a divergent fleet
        would silently never cross-match.
        """
        uids = {eng.register_adapter(spec, weights)
                for eng in self.replicas}
        assert len(uids) == 1, f"replica uid divergence: {sorted(uids)}"
        return uids.pop()

    def unregister_adapter(self, name: str) -> None:
        for eng in self.replicas:
            eng.unregister_adapter(name)

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def _live_indices(self) -> List[int]:
        live = [i for i in range(len(self.replicas))
                if not self._stopped[i]]
        if not live:
            raise RuntimeError("every replica is stopped")
        return live

    def _score(self, i: int, prompt: Sequence[int],
               adapter_name: Optional[str],
               salt: Tuple) -> Tuple[int, int, int]:
        """(cached prefix tokens, adapter affinity, -outstanding): the
        affinity ranking, compared lexicographically, max wins.  The
        adapter term is the graded pool class (2 slot-resident, 1
        staged, 0 host-only) — a replica that already staged the
        weights beats one that must start the H2D copy from scratch."""
        eng = self.replicas[i]
        cached = eng.cached_prefix_tokens(prompt, adapter_name, salt)
        affinity = 0
        if adapter_name is not None:
            affinity = eng.adapter_affinity(adapter_name)
        return (cached, affinity, -eng.outstanding_tokens())

    def _place(self, prompt: Sequence[int], adapter_name: Optional[str],
               salt: Tuple,
               session: Optional[Hashable]) -> Tuple[int, int, bool]:
        """Pick a replica; returns (index, scored cached tokens,
        placed-via-session)."""
        if session is not None:
            pinned = self._sessions.get(session)
            if pinned is not None and not self._stopped[pinned]:
                cached = self.replicas[pinned].cached_prefix_tokens(
                    prompt, adapter_name, salt)
                return pinned, cached, True
        live = self._live_indices()
        if self.policy == "round_robin":
            # cycle over live replicas, blind to locality
            k = self._rr_next % len(live)
            self._rr_next += 1
            idx, cached = live[k], 0
        else:
            best, best_score = live[0], None
            for i in live:
                s = self._score(i, prompt, adapter_name, salt)
                if best_score is None or s > best_score:
                    best, best_score = i, s
            idx, cached = best, best_score[0]
        if session is not None:
            self._sessions[session] = idx
        return idx, cached, False

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               adapter_name: Optional[str] = None,
               arrival_time: Optional[float] = None,
               prefix_embeds: Optional[np.ndarray] = None,
               frame_embeds: Optional[np.ndarray] = None,
               salt: Tuple = (),
               session: Optional[Hashable] = None) -> int:
        """Place + submit one request; returns a ROUTER-global id.

        Same surface as ``Engine.submit`` plus ``session``: a hashable
        key pinning every request that shares it to one replica (sticky
        multi-turn routing).  The global id is stable across drain-time
        rerouting — always resolve results through the router.
        """
        idx, cached, via_session = self._place(prompt, adapter_name,
                                               salt, session)
        eng = self.replicas[idx]
        local = eng.submit(prompt, max_new_tokens,
                           adapter_name=adapter_name,
                           arrival_time=arrival_time,
                           prefix_embeds=prefix_embeds,
                           frame_embeds=frame_embeds, salt=salt)
        gid = self._next_id
        self._next_id += 1
        self._routes[gid] = (idx, local)
        resident = False
        if adapter_name is not None:
            resident = eng.adapter_residency().get(adapter_name, False)
        self.placements.append(Placement(
            req_id=gid, replica=idx, cached_tokens=cached,
            adapter_resident=resident, via_session=via_session))
        if self.tracer.enabled:
            self.tracer.event("router", "placement", None,
                              {"req_id": gid, "replica": idx,
                               "cached_tokens": cached,
                               "adapter_resident": resident,
                               "via_session": via_session})
            self.tracer.count("placements_total")
            self.tracer.count(f"placements_replica_{idx}_total")
        return gid

    # ------------------------------------------------------------------
    # drain / failover
    # ------------------------------------------------------------------
    def stop_replica(self, idx: int) -> int:
        """Stop placing on replica ``idx`` and re-route its queued work.

        Requests still in the replica's arrival/admission queues hold no
        device state — they resubmit to the surviving replicas through
        the normal placement path with their original arrival times,
        adapters and salts, keeping their router-global ids.  Admitted
        requests keep draining on the stopped replica (``step`` keeps
        stepping it until idle), so no request — and no sampled token —
        is ever lost.  Returns the number of re-routed requests.
        """
        if self._stopped[idx]:
            return 0
        if not [i for i in self._live_indices() if i != idx]:
            # refuse BEFORE flipping the flag — a failed stop must leave
            # the fleet routable
            raise RuntimeError("cannot stop the last live replica")
        self._stopped[idx] = True
        eng = self.replicas[idx]
        displaced = list(eng.pending) + list(eng.waiting)
        eng.pending.clear()
        eng.waiting.clear()
        # drop the replica's unclaimed staging-tier prefetches NOW: a
        # stopped replica only steps until its admitted work drains, so
        # the pool's TTL expiry (tick) may never run again and stages
        # prefetched for the re-routed queue would pin HBM forever
        if eng.adapter_pool is not None:
            eng.adapter_pool.drop_unclaimed_stages()
        # forget sessions pinned to the stopped replica; the next turn
        # re-scores (its prefix blocks are gone with the replica anyway)
        self._sessions = {s: r for s, r in self._sessions.items()
                          if r != idx}
        by_local = {local: gid for gid, (r, local) in self._routes.items()
                    if r == idx}
        for req in displaced:
            new_idx, cached, _ = self._place(
                req.prompt, req.adapter.name if req.adapter else None,
                req.salt, None)
            target = self.replicas[new_idx]
            local = target.submit(
                req.prompt, req.max_new_tokens,
                adapter_name=req.adapter.name if req.adapter else None,
                arrival_time=req.arrival_time,
                prefix_embeds=req.prefix_embeds,
                frame_embeds=req.frame_embeds, salt=req.salt)
            gid = by_local.get(req.req_id)
            if gid is not None:
                self._routes[gid] = (new_idx, local)
            self.reroutes += 1
        if self.tracer.enabled:
            self.tracer.event("router", "stop_replica", None,
                              {"replica": idx,
                               "rerouted": len(displaced)})
            self.tracer.count("reroutes_total", len(displaced))
        return len(displaced)

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    def step(self) -> float:
        """Step every replica with live work once.

        One fleet step advances every replica; the returned cost is the
        MAX over replica step times (replicas on their own cards run
        concurrently — summing would double-count overlap, the same rule
        ``merge_aggregates`` applies to throughput).  Replicas sharing
        one card enqueue on its one compute stream, so there they run
        one after another.  Stopped replicas keep stepping until their
        admitted requests drain.
        """
        t = 0.0
        for eng in self.replicas:
            if not eng.idle:
                t = max(t, eng.step())
        return t

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if self.idle:
                return
            self.step()
        raise RuntimeError("router fleet did not drain")

    @property
    def idle(self) -> bool:
        return all(eng.idle for eng in self.replicas)

    # ------------------------------------------------------------------
    # Engine-surface proxies: the replicas are identically configured,
    # so the fleet's model config / adapter registry IS replica 0's —
    # with these the router is drop-in for the pipeline functions
    # (serving/pipelines.py, launch/serve.py) that only touch the
    # submit/run_until_idle/request/metrics_for surface.
    # ------------------------------------------------------------------
    @property
    def cfg(self):
        return self.replicas[0].cfg

    @property
    def adapters(self):
        return self.replicas[0].adapters

    # ------------------------------------------------------------------
    # results / stats
    # ------------------------------------------------------------------
    def replica_of(self, req_id: int) -> int:
        return self._routes[req_id][0]

    def request(self, req_id: int) -> Request:
        idx, local = self._routes[req_id]
        return self.replicas[idx].request(local)

    def metrics_for(self, req_ids: Sequence[int]) -> MetricsAggregate:
        """Fleet aggregate over the given router-global ids: per-replica
        aggregates merged without double-counting overlapped wall-clock
        (fleet throughput uses the min-arrival→max-done makespan)."""
        by_replica: Dict[int, List[int]] = {}
        for gid in req_ids:
            idx, local = self._routes[gid]
            by_replica.setdefault(idx, []).append(local)
        parts = [self.replicas[idx].metrics_for(locals_)
                 for idx, locals_ in sorted(by_replica.items())]
        return merge_aggregates(parts)

    def per_replica_metrics(self, req_ids: Sequence[int]
                            ) -> Dict[int, MetricsAggregate]:
        """Replica index → aggregate over its share of ``req_ids``."""
        by_replica: Dict[int, List[int]] = {}
        for gid in req_ids:
            idx, local = self._routes[gid]
            by_replica.setdefault(idx, []).append(local)
        return {idx: self.replicas[idx].metrics_for(locals_)
                for idx, locals_ in sorted(by_replica.items())}

    def kv_hit_rate(self) -> float:
        """Fleet prefix-cache hit rate: summed hits over summed lookups
        (NOT a mean of per-replica rates — replicas see different
        admission counts under affinity routing)."""
        hits = total = 0
        for eng in self.replicas:
            mgr = eng.kv_mgr or eng.st_mgr
            hits += mgr.hits
            total += mgr.hits + mgr.misses
        return hits / total if total else 0.0
