"""Hot-path-safe trace recording: the ``Tracer`` the engine, runner and
adapter pool stamp spans, events, counters and cache-reuse ledger rows
into.  A copy of the reference's ``repro/obs/tracer.py``.

Recording is append-only plain Python: no torch calls, no device work,
nothing that could synchronise with the card.  Tracer methods run in
the engine's schedule and submit phases, where one hidden device sync
per step would stall the async pipeline.

Two timestamps ride every record: ``t0``/``t1`` are host wall time
(``time.perf_counter()`` seconds) and ``vclock`` is the engine's virtual
clock at record time (``None`` where no clock exists).

The event and ledger rings trim their oldest half in bulk at
``TRACE_RING_MAX``; ``Tracer.dropped`` counts what the trim discarded.
``REPRO_TRACE=0`` disables recording at construction;
``EngineConfig.trace`` overrides the environment per engine.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

TRACE_RING_MAX = 65536
TRACE_RING_KEEP = 32768

# event-record and ledger-record field order (the schema
# ``repro_torch.obs.export`` renders)
EVENT_FIELDS = ("kind", "track", "name", "t0", "t1", "vclock", "args")
LEDGER_FIELDS = ("req_id", "adapter_uid", "reused", "recomputed",
                 "state_reused", "vclock")
# track vocabulary (one Perfetto thread per track)
TRACKS = ("schedule", "submit", "retire", "pool", "router", "lifecycle")

EventRec = Tuple[str, str, str, float, float, Optional[float],
                 Optional[Dict[str, Any]]]
LedgerRec = Tuple[int, Optional[str], int, int, bool, Optional[float]]


def trace_enabled_default() -> bool:
    """Tracing is ON by default; ``REPRO_TRACE=0`` is the kill switch."""
    return os.environ.get("REPRO_TRACE", "1") != "0"


class Tracer:
    """Bounded-ring trace recorder (one per engine or router)."""

    def __init__(self, enabled: Optional[bool] = None, replica: int = 0):
        self.enabled = trace_enabled_default() if enabled is None \
            else bool(enabled)
        self.replica = replica
        self.events: List[EventRec] = []
        self.ledger: List[LedgerRec] = []
        self.counters: Dict[str, float] = {}
        self.dropped = 0

    def set_replica(self, replica: int) -> None:
        """Stamp this tracer's fleet position (the router assigns these
        so per-replica Perfetto tracks line up with placement events)."""
        self.replica = replica

    def _append(self, ring: List[Any], rec: Any) -> None:
        if len(ring) >= TRACE_RING_MAX:
            drop = len(ring) - TRACE_RING_KEEP
            del ring[:drop]
            self.dropped += drop
        ring.append(rec)

    def span(self, track: str, name: str, t0: float, t1: float,
             vclock: Optional[float],
             args: Optional[Dict[str, Any]] = None) -> None:
        """A completed interval [t0, t1] (wall seconds) on ``track``."""
        if not self.enabled:
            return
        self._append(self.events, ("span", track, name, t0, t1, vclock,
                                   args))

    def event(self, track: str, name: str, vclock: Optional[float],
              args: Optional[Dict[str, Any]] = None) -> None:
        """An instant event, wall-stamped here at record time."""
        if not self.enabled:
            return
        t = time.perf_counter()
        self._append(self.events, ("event", track, name, t, t, vclock,
                                   args))

    def count(self, name: str, delta: float = 1.0) -> None:
        """Bump a monotonic counter."""
        if not self.enabled:
            return
        self.counters[name] = self.counters.get(name, 0.0) + delta

    def ledger_entry(self, req_id: int, adapter_uid: Optional[str],
                     reused: int, recomputed: int, state_reused: bool,
                     vclock: Optional[float]) -> None:
        """One cache-reuse ledger row per successful admission: ``reused``
        prefix tokens the cache served (blocks prefilled by the base
        model or sibling adapters included), ``recomputed`` the prompt
        remainder prefill executes.  Over a run without failed admissions
        the reused total equals ``BlockManager.hits * block_size``."""
        if not self.enabled:
            return
        self._append(self.ledger, (req_id, adapter_uid, int(reused),
                                   int(recomputed), bool(state_reused),
                                   vclock))
        self.count("tokens_reused_total", reused)
        self.count("tokens_recomputed_total", recomputed)
        self.count("admissions_total")

    def request_summary(self, req_id: int, adapter_uid: Optional[str],
                        arrival: float, t_prefill_start: Optional[float],
                        t_decode_start: Optional[float], t_done: float,
                        prompt_len: int, output_len: int,
                        cache_hit_tokens: int) -> None:
        """The lifecycle of a finished request, in virtual-clock seconds."""
        if not self.enabled:
            return
        t = time.perf_counter()
        self._append(self.events, (
            "request", "lifecycle", "request", t, t, t_done,
            {"req_id": req_id, "adapter_uid": adapter_uid,
             "arrival": arrival, "t_prefill_start": t_prefill_start,
             "t_decode_start": t_decode_start, "t_done": t_done,
             "prompt_len": prompt_len, "output_len": output_len,
             "cache_hit_tokens": cache_hit_tokens}))
        self.count("requests_finished_total")
