"""Trace exporters, a copy of the reference's ``repro/obs/export.py``:
everything that turns ``Tracer`` rings into artifacts.  Runs strictly
off the step path (after a run, or from a command line), so unlike
``repro_torch.obs.tracer`` this module may do real work: JSON encoding,
byte accounting, aggregation.

Three formats:

* **Perfetto / Chrome trace JSON** (``to_perfetto``/``write_perfetto``):
  load the file at https://ui.perfetto.dev.  One process per replica
  carrying the step-phase tracks (schedule / submit / retire / pool) on
  the wall-clock timebase, one process per replica for request
  lifecycles (queue → prefill → decode spans per request) on the
  virtual-clock timebase, and one process for the router's placement
  decisions.  A port ring whose request summaries carry the wall stamps
  (``t_submit_wall`` …) draws its lifecycles on the wall clock instead,
  in line with the step phases.
* **Prometheus text** (``prometheus_text``): a counters snapshot in the
  text exposition format, one ``repro_*`` counter family per
  ``Tracer.counters`` key with a ``replica`` label — what
  ``launch/serve.py --metrics-out`` writes.
* **JSONL** (``trace_records``/``write_jsonl``): every event, ledger row
  and counter as a flat dict.

The output equals the reference's on the same rings: the same PID/TID
layout, counter family names and ``replica`` labels.  Rings without wall
stamps, the reference's among them, render exactly as the reference
renders them.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.tracer import EVENT_FIELDS, LEDGER_FIELDS, Tracer

# Perfetto process-id layout: phase tracks at PID_PHASE+replica,
# request lifecycles at PID_LIFECYCLE+replica, the router at PID_ROUTER
PID_PHASE = 1
PID_LIFECYCLE = 1001
PID_ROUTER = 2001
# thread id per phase track inside a replica's phase process
TRACK_TIDS = {"schedule": 1, "submit": 2, "retire": 3, "pool": 4,
              "router": 5, "lifecycle": 6}


def _us(t: Optional[float]) -> float:
    return 0.0 if t is None else t * 1e6


def _meta(pid: int, name: str, tid: Optional[int] = None,
          tname: Optional[str] = None) -> List[Dict[str, Any]]:
    """Metadata records; an empty ``name`` emits no process_name record
    (it would override the real one — later M records win in
    Perfetto)."""
    out: List[Dict[str, Any]] = []
    if name:
        out.append({"name": "process_name", "ph": "M", "pid": pid,
                    "tid": 0, "args": {"name": name}})
    if tid is not None:
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": tname or ""}})
    return out


def _wall_ring(tr: Tracer) -> bool:
    """Whether ``tr``'s request summaries carry the port's wall stamps."""
    return any(kind == "request" and (args or {}).get("t_submit_wall")
               is not None for kind, _, _, _, _, _, args in tr.events)


def _ledger_marks(tr: Tracer, wall: bool) -> List[Tuple[Tuple, float]]:
    """Each ledger row with the time of its ``admit`` mark: its virtual
    clock, or on a wall ring the end of the ``admit`` span of the same
    admission.  The rings trim their oldest records apart, so a
    request's rows pair with its successful admissions from the newest
    back; a row whose span is gone is not drawn."""
    if not wall:
        return [(row, row[5]) for row in tr.ledger]
    ends: Dict[int, List[float]] = {}
    for kind, _, name, _, t1, _, a in tr.events:
        if kind == "span" and name == "admit" and a and a.get("ok"):
            ends.setdefault(a["req_id"], []).append(t1)
    marks = []
    for row in reversed(tr.ledger):
        left = ends.get(row[0])
        if left:
            marks.append((row, left.pop()))
    return marks[::-1]


def to_perfetto(tracers: Sequence[Tracer]) -> Dict[str, Any]:
    """Chrome-trace/Perfetto JSON for a set of tracers (one per replica,
    plus optionally the router's)."""
    ev: List[Dict[str, Any]] = []
    for tr in tracers:
        if tr.replica < 0:          # the router's own tracer
            pid_phase = PID_ROUTER
            ev += _meta(pid_phase, "router")
        else:
            pid_phase = PID_PHASE + tr.replica
            ev += _meta(pid_phase, f"replica {tr.replica} · step phases")
        pid_life = PID_LIFECYCLE + max(tr.replica, 0)
        wall = _wall_ring(tr)
        life_name = f"replica {max(tr.replica, 0)} · requests " \
            f"({'wall' if wall else 'virtual'} clock)"
        # the summary's bounds of queue → prefill → decode
        stamps = ("t_submit_wall", "t_admit_wall", "t_first_token_wall",
                  "t_done_wall") if wall \
            else ("arrival", "t_prefill_start", "t_decode_start", "t_done")
        named_tids = set()
        life_named = False
        for kind, track, name, t0, t1, vclock, args in tr.events:
            if kind == "request":
                # expand the lifecycle summary into queue/prefill/decode
                # spans on the request process
                if not life_named:
                    ev += _meta(pid_life, life_name)
                    life_named = True
                a = args or {}
                rid = int(a.get("req_id", 0))
                tid = rid + 1
                ev += _meta(pid_life, "", tid,
                            f"req {rid} [{a.get('adapter_uid') or 'base'}]")
                bounds = [(sname, a.get(lo), a.get(hi)) for sname, lo, hi
                          in zip(("queue", "prefill", "decode"), stamps,
                                 stamps[1:])]
                for sname, lo, hi in bounds:
                    if lo is None or hi is None:
                        continue
                    ev.append({"name": sname, "ph": "X", "pid": pid_life,
                               "tid": tid, "ts": _us(lo),
                               "dur": max(_us(hi) - _us(lo), 0.0),
                               "args": a})
                continue
            if track == "lifecycle":
                # arrival marks etc.: instants on the request process,
                # threaded by request id
                if not life_named:
                    ev += _meta(pid_life, life_name)
                    life_named = True
                a = args or {}
                ev.append({"name": name, "ph": "i", "s": "t",
                           "pid": pid_life,
                           "tid": int(a.get("req_id", 0)) + 1,
                           "ts": _us(t0 if wall else vclock), "args": a})
                continue
            tid = TRACK_TIDS.get(track, 9)
            if tid not in named_tids:
                ev += _meta(pid_phase, "", tid, track)
                named_tids.add(tid)
            rec: Dict[str, Any] = {"name": name, "pid": pid_phase,
                                   "tid": tid, "ts": _us(t0)}
            if args or vclock is not None:
                rec["args"] = dict(args or {})
                if vclock is not None:
                    rec["args"]["vclock"] = vclock
            if kind == "span":
                rec["ph"] = "X"
                rec["dur"] = max(_us(t1) - _us(t0), 0.0)
            else:
                rec["ph"] = "i"
                rec["s"] = "t"
            ev.append(rec)
        # ledger rows: instant "admit" marks on the request timeline at
        # their admission time (the cache-probe verdict)
        for (req_id, uid, reused, recomp, state_reused, _), ts \
                in _ledger_marks(tr, wall):
            if not life_named:
                ev += _meta(pid_life, life_name)
                life_named = True
            ev.append({"name": "admit", "ph": "i", "s": "t",
                       "pid": pid_life, "tid": req_id + 1,
                       "ts": _us(ts),
                       "args": {"adapter_uid": uid, "reused": reused,
                                "recomputed": recomp,
                                "state_reused": state_reused}})
    return {"traceEvents": ev, "displayTimeUnit": "ms"}


def write_perfetto(path: str, tracers: Sequence[Tracer]) -> None:
    with open(path, "w") as f:
        json.dump(to_perfetto(tracers), f)


# ---------------------------------------------------------------------------
def trace_records(tracers: Sequence[Tracer]) -> List[Dict[str, Any]]:
    """Every event + ledger row + counter as flat JSONL-able dicts."""
    out: List[Dict[str, Any]] = []
    for tr in tracers:
        for evt in tr.events:
            rec = dict(zip(EVENT_FIELDS, evt))
            rec["replica"] = tr.replica
            out.append(rec)
        for row in tr.ledger:
            rec = dict(zip(LEDGER_FIELDS, row))
            rec["kind"] = "ledger"
            rec["replica"] = tr.replica
            out.append(rec)
        for name, val in sorted(tr.counters.items()):
            out.append({"kind": "counter", "name": name, "value": val,
                        "replica": tr.replica})
        if tr.dropped:
            out.append({"kind": "dropped", "value": tr.dropped,
                        "replica": tr.replica})
    return out


def write_jsonl(path: str, tracers: Sequence[Tracer]) -> None:
    with open(path, "w") as f:
        for rec in trace_records(tracers):
            f.write(json.dumps(rec) + "\n")


# ---------------------------------------------------------------------------
def prometheus_text(tracers: Sequence[Tracer]) -> str:
    """Counters snapshot in the Prometheus text exposition format.
    Counter families are ``repro_<name>`` with a ``replica`` label
    (``"router"`` for the router's own tracer)."""
    by_name: Dict[str, List[Tuple[str, float]]] = {}
    for tr in tracers:
        label = "router" if tr.replica < 0 else str(tr.replica)
        for name, val in tr.counters.items():
            by_name.setdefault(name, []).append((label, val))
    lines: List[str] = []
    for name in sorted(by_name):
        fam = f"repro_{name}"
        lines.append(f"# TYPE {fam} counter")
        for label, val in sorted(by_name[name]):
            lines.append(f'{fam}{{replica="{label}"}} {val:g}')
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
def reuse_by_adapter(tracers: Sequence[Tracer]
                     ) -> Dict[str, Dict[str, float]]:
    """Ledger rows aggregated per adapter uid (``"base"`` for
    adapter-less requests): admissions, tokens reused vs recomputed and
    the resulting reuse fraction — the paper's central quantity as a
    table instead of a hidden counter."""
    out: Dict[str, Dict[str, float]] = {}
    for tr in tracers:
        for _req, uid, reused, recomp, state_reused, _vc in tr.ledger:
            row = out.setdefault(uid or "base", {
                "admissions": 0.0, "reused": 0.0, "recomputed": 0.0,
                "state_reuses": 0.0})
            row["admissions"] += 1
            row["reused"] += reused
            row["recomputed"] += recomp
            row["state_reuses"] += bool(state_reused)
    for row in out.values():
        tot = row["reused"] + row["recomputed"]
        row["reuse_frac"] = row["reused"] / tot if tot else 0.0
    return out


# ---------------------------------------------------------------------------
def d2h_summary(fetches: Iterable[Tuple[int, str, str]]
                ) -> Dict[str, Dict[str, float]]:
    """Aggregate a ``ModelRunner.d2h_fetches`` ring (``(elems, dtype,
    tag)`` rows) into per-tag transfer counts / element / byte totals —
    the ids-only-D2H invariant as a human-readable table."""
    out: Dict[str, Dict[str, float]] = {}
    for elems, dtype, tag in fetches:
        row = out.setdefault(tag, {"count": 0.0, "elems": 0.0,
                                   "bytes": 0.0})
        row["count"] += 1
        row["elems"] += elems
        row["bytes"] += elems * np.dtype(dtype).itemsize
    return out
