"""The open-loop driver: submits each request to the engine when it is
due, steps the engine, and stamps on the host clock what a client would
see.

A session's first request is due at its arrival offset from the start
of traffic; each follow-up is due when the request before it finished.
After every ``Engine.step()`` the driver reads each live request's
``output_tokens``: a token counts from the first reading at which it
holds a retired id (not the engine's PENDING placeholder), and the
request has finished when the engine marks it done.  Nothing is read
from the engine's virtual clock."""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

PENDING = -1          # the engine's placeholder for a token still on the card


class Tracked:
    """One request as the client sees it."""
    __slots__ = ("rid", "turn", "session", "due", "req", "in_window",
                 "tok_times", "t_done", "prompt_len")

    def __init__(self, rid, turn, session, due, req, in_window):
        self.rid, self.turn, self.session = rid, turn, session
        self.due, self.req, self.in_window = due, req, in_window
        self.tok_times: List[float] = []
        self.t_done: Optional[float] = None
        self.prompt_len = len(turn.prompt)

    @property
    def kind(self) -> str:
        return self.turn.kind

    @property
    def t_first(self) -> Optional[float]:
        return self.tok_times[0] if self.tok_times else None

    def outputs(self) -> List[int]:
        return list(self.req.output_tokens)


class Driver:
    """Feeds ``traffic`` ((offset s, session) in order) to ``eng``.
    ``adapter_names[i]``: the engine's name of adapter i."""

    def __init__(self, eng, traffic: Iterator[Tuple[float, object]],
                 adapter_names: Sequence[str], done_state):
        self.eng = eng
        self.traffic = traffic
        self.names = list(adapter_names)
        self.done_state = done_state
        self.t0: Optional[float] = None
        self.next_arrival = next(traffic)
        self.live: Dict[int, Tracked] = {}
        self.finished: List[Tracked] = []
        self.window: Optional[Tuple[float, float]] = None
        self.steps = 0
        # called before each step with the host time (the traced run's
        # profiler window)
        self.before_step: Optional[Callable[[float], None]] = None

    # ------------------------------------------------------------------
    def _submit(self, session, turn, due: float) -> None:
        name = None if turn.adapter is None else self.names[turn.adapter]
        rid = self.eng.submit(turn.prompt, turn.max_new, adapter_name=name)
        # due now on the engine's clock, so queued at the back of waiting
        req = self.eng.waiting[-1]
        if req.req_id != rid:
            req = self.eng.request(rid)
        w = self.window
        tr = Tracked(rid, turn, session, due, req,
                     w is not None and w[0] <= due < w[1])
        self.live[rid] = tr

    def _poll(self, now: float) -> None:
        done = []
        for rid, tr in self.live.items():
            out = tr.req.output_tokens
            n = len(out) - (1 if out and out[-1] == PENDING else 0)
            while len(tr.tok_times) < n:
                tr.tok_times.append(now)
            if tr.req.state == self.done_state:
                done.append(rid)
        for rid in done:
            tr = self.live.pop(rid)
            tr.t_done = now
            self.finished.append(tr)
            nxt = tr.session.follow(tr.turn.prompt, tr.outputs())
            if nxt is not None:
                self._submit(tr.session, nxt, now)

    def run(self, until: float, stop: Optional[Callable[[], bool]] = None
            ) -> None:
        """Serve until the host clock reaches ``until`` or ``stop()``."""
        if self.t0 is None:
            self.t0 = time.perf_counter()
        eng = self.eng
        while True:
            now = time.perf_counter()
            if now >= until or (stop is not None and stop()):
                return
            while self.t0 + self.next_arrival[0] <= now:
                off, session = self.next_arrival
                self._submit(session, session.first(), self.t0 + off)
                self.next_arrival = next(self.traffic)
            if eng.idle:
                nxt = self.t0 + self.next_arrival[0]
                time.sleep(max(0.0, min(nxt, until) - now))
                continue
            if self.before_step is not None:
                self.before_step(now)
            eng.step()
            self.steps += 1
            self._poll(time.perf_counter())

    # ------------------------------------------------------------------
    def all_requests(self) -> List[Tracked]:
        return self.finished + list(self.live.values())

    def window_requests(self) -> List[Tracked]:
        return [t for t in self.all_requests() if t.in_window]

    def window_pending(self) -> bool:
        return any(t.in_window for t in self.live.values())
