"""Resource-lifecycle check (Pass C of the invariant analyzer), the
reference's ``repro/analysis/lifecycle_check.py`` over the port: a
path-sensitive AST dataflow analysis over ``serving/`` proving the
scheduler never leaks an acquire-shaped resource.

The class of bug it catches is a host-side ownership leak on some exit
path: an admission rollback that forgets the blocks it matched, a
preemption that forgets one kind of per-request resource, a speculative
block claim dropped on ``OutOfBlocks``, a staged adapter copy no
registry owns, a prefetch window that collapses when the engine is full.

Tracked resources (the acquire table below):

  kv       ``kv_mgr.allocate()`` / ``kv_mgr.acquire(id)`` and the
           ``kv_blocks`` field of ``cache.match_and_acquire``
  state    ``st_mgr.allocate()`` and the ``state_slot`` field of
           ``cache.match_and_acquire`` (optional: may be None)
  adapter  ``adapter_pool.acquire(uid)`` (optional: None on failure)
  runslot  ``self._free_slots.pop()``
  staged   a store of non-None to ``<reg>.device_layers`` (the
           staging-tier device copy of prefetched adapter weights)

The reference also tracks ``xkv``, the per-request encoder K/V stack
``runner.encode`` returns and ``_xkv.pop`` releases.  The port has no
such stack: ``ModelRunner.encode`` writes an encoder-decoder request's
cross K/V into its run slot of the runner's encoder pools, which the
slot's next admission overwrites.  The encoder K/V therefore live and
die with the run slot, which ``runslot`` already tracks, so ``encode``
acquires nothing here and the teardown table asks for no ``xkv``.

For every function, every exit path — ``return``, ``raise``, fall off
the end, and ``continue``/``break`` for handles acquired inside the
current loop body — must leave each acquired handle RELEASED (the
paired release call ran) or TRANSFERRED into a recognized owner:

  * a store into an attribute chain (``req.block_ids = ...``,
    ``r.block_ids.append(...)``, ``r.block_ids[b] = canon``) — the
    object now owns the resource and a teardown path is responsible for
    it (see the teardown table);
  * a ``self._staged[...] = ...`` store (the staging registry claims
    the staged copy; ``tick``/``_drop_stage`` expire it);
  * being returned/yielded (ownership flows to the caller);
  * an explicit ``# owner: <who>`` annotation on the acquire line —
    audited: an ``# owner:`` comment that is not attached to a
    recognized acquire site is itself a violation (``owner-unused``),
    so silenced false positives cannot rot into silenced true ones.

The analysis is optimistic across branch merges (a handle released on
one arm of an ``if`` the analysis cannot correlate — e.g. a rollback
guarded by a bool flag — counts as released) but exact on each exit:
a ``return`` inside a branch is checked with that branch's own state.
Exception edges are approximated per statement: a ``try`` handler sees
the state *before* each simple statement (an acquire that raised never
produced a handle) and *after* each compound one (a partially
completed allocation loop is live in the handler).  Locally defined
closures (the ``bail()`` rollback idiom) are inlined at their call
sites.  ``if x is None`` narrows optional handles out of the true arm.

Two structural checks ride along, covering leaks pure ownership
dataflow cannot express:

  teardown-missing   functions in the teardown table (``_preempt``,
                     ``_finish_requests``) must contain a release of
                     every per-request resource kind
  window-collapse    a loop bound of the occupancy-complement shape
                     (``... - len(...)``) guarding a prefetch/stage
                     call — a full engine would issue zero prefetches;
                     the window must be a config knob, not spare
                     capacity

Tables name code that must exist: a stale entry is a
``lifecycle-table`` violation, so the tables cannot rot.  Fixture
coverage (each leak shape flagged, clean as fixed) lives in
``tests/test_torch_analysis.py``.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.hotpath_lint import (KERNEL_EXEMPT_FILES,
                                              OBS_EXPORT_FILES, Violation,
                                              _Func, _index_functions,
                                              _py_files, _qualname)

OWNER_ANNOTATION = "# owner:"

# statuses a live handle can be in; anything not HELD is safe at exits
HELD = "held"
RELEASED = "released"
TRANSFERRED = "transferred"

# instance-attribute names that identify a resource manager when used
# as a call receiver (directly, or through a local alias like
# ``mgr = self.kv_mgr``)
MANAGER_ATTRS = frozenset({"kv_mgr", "st_mgr", "adapter_pool", "cache",
                           "_free_slots"})

# (manager, method) → kind of the handle the call creates.  bind_arg
# marks refcount-style acquires (``kv_mgr.acquire(canon)``) where the
# new reference is also bound to the argument name.
_ACQUIRES: Dict[Tuple[str, str], Tuple[str, bool, bool]] = {
    # (manager, method): (kind, optional, bind_arg)
    ("kv_mgr", "allocate"): ("kv", False, False),
    ("kv_mgr", "acquire"): ("kv", False, True),
    ("st_mgr", "allocate"): ("state", False, False),
    ("adapter_pool", "acquire"): ("adapter", True, False),
    ("_free_slots", "pop"): ("runslot", False, False),
}
# ``cache.match_and_acquire`` returns a match object owning two
# resources, reached through field reads on the result
_BUNDLE_FIELDS: Tuple[Tuple[str, str, bool], ...] = (
    # (field name, kind, optional)
    ("kv_blocks", "kv", False),
    ("state_slot", "state", True),
)

# (manager, method) → value-keyed release: handles bound in the
# argument expressions are released
_RELEASES_BY_VALUE = frozenset({
    ("kv_mgr", "release"), ("kv_mgr", "release_all"),
    ("st_mgr", "release"), ("_free_slots", "append"),
})
# (manager, method) → kind-matched release: releases every held handle
# of the kind (the call is keyed by uid/req-id, not by the handle
# value, so value tracking cannot pair it)
_RELEASES_BY_KIND: Dict[Tuple[str, str], str] = {
    ("adapter_pool", "release"): "adapter",
}

# per-request teardown functions and the release kinds each MUST
# contain (no ``xkv``: the encoder K/V go back with the run slot)
TEARDOWN_FUNCS: Dict[Tuple[Optional[str], str], FrozenSet[str]] = {
    ("Engine", "_preempt"): frozenset({"kv", "runslot", "adapter"}),
    ("Engine", "_finish_requests"): frozenset({"kv", "runslot",
                                               "adapter"}),
}
# calls that consume a prefetch window (the window-collapse check)
_PREFETCH_METHODS = frozenset({"prefetch", "stage", "_stage"})


@dataclass(frozen=True)
class _Handle:
    """One acquire site.  Keyed by site so loop re-executions rebind
    the same summary handle; ``bfield`` tags bundle members so they
    only flow through the matching attribute read."""
    kind: str
    line: int
    bfield: Optional[str] = None
    optional: bool = False


@dataclass
class _State:
    bindings: Dict[str, FrozenSet[_Handle]] = field(default_factory=dict)
    status: Dict[_Handle, str] = field(default_factory=dict)
    aliases: Dict[str, str] = field(default_factory=dict)

    def clone(self) -> "_State":
        return _State(dict(self.bindings), dict(self.status),
                      dict(self.aliases))


def _merge(states: List[_State]) -> _State:
    """Optimistic merge: a handle released or transferred on any arm
    counts as safe; a handle absent from an arm keeps the other arm's
    status (it was never acquired there)."""
    out = _State()
    for st in states:
        for var, hs in st.bindings.items():
            out.bindings[var] = out.bindings.get(var, frozenset()) | hs
        out.aliases.update(st.aliases)
    all_handles: Set[_Handle] = set()
    for st in states:
        all_handles.update(st.status)
    for h in all_handles:
        statuses = [st.status[h] for st in states if h in st.status]
        if TRANSFERRED in statuses:
            out.status[h] = TRANSFERRED
        elif RELEASED in statuses:
            out.status[h] = RELEASED
        else:
            out.status[h] = HELD
    return out


@dataclass
class _Flow:
    """Result of executing a statement list: the fall-through state
    (None if every path terminated) plus states pending at break /
    continue, to be merged at the enclosing loop."""
    out: Optional[_State]
    breaks: List[_State]
    continues: List[_State]


_SIMPLE_STMTS = (ast.Assign, ast.AnnAssign, ast.AugAssign, ast.Expr,
                 ast.Assert, ast.Pass, ast.Import, ast.ImportFrom,
                 ast.Global, ast.Nonlocal, ast.Delete)


class _FunctionChecker:
    """Interprets one function body over the abstract handle domain."""

    def __init__(self, fobj: _Func, qualname: str,
                 violations: List[Violation],
                 owner_used: Set[Tuple[str, int]]) -> None:
        self.path = fobj.path
        self.lines = fobj.source_lines
        self.qn = qualname
        self.violations = violations
        self.owner_used = owner_used
        self.local_defs: Dict[str, ast.FunctionDef] = {}
        self._inline_stack: List[str] = []
        # stack of handle-key snapshots at loop entry — continue/break
        # only leak-check handles acquired inside the current loop body
        self._loop_snapshots: List[Set[_Handle]] = []
        # closure inlining: returns inside an inlined body are not
        # function exits; they accumulate (state, handles) here instead
        self._closure_returns: List[List[Tuple[_State,
                                               FrozenSet[_Handle]]]] = []

    # ---------------------------------------------------------- helpers
    def _owner_annotated(self, lineno: int) -> bool:
        for ln in (lineno, lineno - 1):
            if 1 <= ln <= len(self.lines) \
                    and OWNER_ANNOTATION in self.lines[ln - 1]:
                self.owner_used.add((self.path, ln))
                return True
        return False

    def _manager_of(self, expr: ast.expr, st: _State) -> Optional[str]:
        """Classify a call receiver / store base as a resource manager:
        ``self.kv_mgr`` (any base object), or a local alias of one."""
        if isinstance(expr, ast.Attribute) and expr.attr in MANAGER_ATTRS:
            return expr.attr
        if isinstance(expr, ast.Name):
            return st.aliases.get(expr.id)
        return None

    def _leak_check(self, st: _State, lineno: int, what: str,
                    only: Optional[Set[_Handle]] = None) -> None:
        for h, status in sorted(st.status.items(),
                                key=lambda kv: kv[0].line):
            if status != HELD:
                continue
            if only is not None and h not in only:
                continue
            self.violations.append(Violation(
                self.path, lineno, "leak",
                f"{self.qn}: {h.kind} resource acquired at line "
                f"{h.line} is still held at the {what} on line "
                f"{lineno} — release it, transfer it to an owner "
                f"(Request field / pool registry / return value), or "
                f"annotate the acquire with '{OWNER_ANNOTATION} <who>'"))

    def _exit(self, st: _State, lineno: int, what: str) -> None:
        self._leak_check(st, lineno, what)

    def _loop_local(self, st: _State) -> Optional[Set[_Handle]]:
        if not self._loop_snapshots:
            return set()
        return set(st.status) - self._loop_snapshots[-1]

    # ------------------------------------------------- expression eval
    def _eval(self, expr: Optional[ast.expr], st: _State
              ) -> FrozenSet[_Handle]:
        """Handle-set of an expression, applying acquire/release side
        effects of any calls inside it."""
        if expr is None:
            return frozenset()
        if isinstance(expr, ast.Name):
            return st.bindings.get(expr.id, frozenset())
        if isinstance(expr, ast.Attribute):
            base = self._eval(expr.value, st)
            # bundle members flow through the matching field read only;
            # plain handles never propagate through attribute reads
            return frozenset(h for h in base if h.bfield == expr.attr)
        if isinstance(expr, ast.Call):
            return self._eval_call(expr, st)
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            out: FrozenSet[_Handle] = frozenset()
            for e in expr.elts:
                out |= self._eval(e, st)
            return out
        if isinstance(expr, ast.Dict):
            out = frozenset()
            for k, v in zip(expr.keys, expr.values):
                if k is not None:
                    self._eval(k, st)
                out |= self._eval(v, st)
            return out
        if isinstance(expr, ast.BinOp):
            return self._eval(expr.left, st) | self._eval(expr.right, st)
        if isinstance(expr, ast.BoolOp):
            out = frozenset()
            for v in expr.values:
                out |= self._eval(v, st)
            return out
        if isinstance(expr, ast.IfExp):
            self._eval(expr.test, st)
            return self._eval(expr.body, st) | self._eval(expr.orelse, st)
        if isinstance(expr, ast.UnaryOp):
            return self._eval(expr.operand, st)
        if isinstance(expr, ast.Starred):
            return self._eval(expr.value, st)
        if isinstance(expr, ast.Compare):
            self._eval(expr.left, st)
            for c in expr.comparators:
                self._eval(c, st)
            return frozenset()
        if isinstance(expr, ast.Subscript):
            self._eval(expr.value, st)
            self._eval(expr.slice, st)
            return frozenset()
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            for gen in expr.generators:
                self._eval(gen.iter, st)
            return frozenset()
        if isinstance(expr, ast.Slice):
            self._eval(expr.lower, st)
            self._eval(expr.upper, st)
            self._eval(expr.step, st)
            return frozenset()
        if isinstance(expr, ast.JoinedStr):
            return frozenset()
        return frozenset()

    def _eval_call(self, call: ast.Call, st: _State
                   ) -> FrozenSet[_Handle]:
        fn = call.func
        arg_handles: List[FrozenSet[_Handle]] = []
        for a in call.args:
            arg_handles.append(self._eval(a, st))
        for kw in call.keywords:
            arg_handles.append(self._eval(kw.value, st))

        if isinstance(fn, ast.Attribute):
            mgr = self._manager_of(fn.value, st)
            key = (mgr, fn.attr) if mgr is not None else None
            if key in _RELEASES_BY_VALUE:
                for hs in arg_handles:
                    for h in hs:
                        if st.status.get(h) == HELD:
                            st.status[h] = RELEASED
                return frozenset()
            if key in _RELEASES_BY_KIND:
                kind = _RELEASES_BY_KIND[key]          # type: ignore[index]
                for h, status in st.status.items():
                    if h.kind == kind and status == HELD:
                        st.status[h] = RELEASED
                return frozenset()
            if key in _ACQUIRES:
                kind, optional, bind_arg = _ACQUIRES[key]  # type: ignore[index]
                h = _Handle(kind, call.lineno, optional=optional)
                st.status[h] = TRANSFERRED \
                    if self._owner_annotated(call.lineno) else HELD
                if bind_arg:
                    for a in call.args:
                        if isinstance(a, ast.Name):
                            st.bindings[a.id] = \
                                st.bindings.get(a.id, frozenset()) \
                                | frozenset({h})
                return frozenset({h})
            if key == ("cache", "match_and_acquire"):
                annotated = self._owner_annotated(call.lineno)
                out: Set[_Handle] = set()
                for bfield, kind, optional in _BUNDLE_FIELDS:
                    h = _Handle(kind, call.lineno, bfield=bfield,
                                optional=optional)
                    st.status[h] = TRANSFERRED if annotated else HELD
                    out.add(h)
                return frozenset(out)
            # list mutators on tracked containers
            if fn.attr in ("append", "extend", "insert", "add"):
                moved = frozenset().union(*arg_handles) \
                    if arg_handles else frozenset()
                if isinstance(fn.value, ast.Name):
                    # local container keeps the binding (release_all on
                    # the container name still pairs with it)
                    var = fn.value.id
                    st.bindings[var] = \
                        st.bindings.get(var, frozenset()) | moved
                else:
                    # attribute-chain container: the object owns it now
                    for h in moved:
                        if st.status.get(h) == HELD:
                            st.status[h] = TRANSFERRED
                return frozenset()
            self._eval(fn.value, st)
            return frozenset().union(*arg_handles) \
                if arg_handles else frozenset()

        if isinstance(fn, ast.Name) and fn.id in self.local_defs \
                and fn.id not in self._inline_stack:
            return self._inline_closure(fn.id, st)

        return frozenset().union(*arg_handles) \
            if arg_handles else frozenset()

    def _inline_closure(self, name: str, st: _State
                        ) -> FrozenSet[_Handle]:
        """Interpret a locally defined ``def`` (the ``bail()`` rollback
        idiom) in the caller's state: its releases apply here, its
        internal returns are not function exits."""
        self._inline_stack.append(name)
        self._closure_returns.append([])
        flow = self._exec_stmts(self.local_defs[name].body, st.clone())
        rets = self._closure_returns.pop()
        self._inline_stack.pop()
        outs = [s for s, _ in rets]
        if flow.out is not None:
            outs.append(flow.out)
        merged = _merge(outs) if outs else st.clone()
        st.bindings = merged.bindings
        st.status = merged.status
        st.aliases = merged.aliases
        result: FrozenSet[_Handle] = frozenset()
        for _, hs in rets:
            result |= hs
        return result

    # ------------------------------------------------- store semantics
    def _assign_target(self, target: ast.expr,
                       value_handles: FrozenSet[_Handle],
                       value: Optional[ast.expr], st: _State) -> None:
        if isinstance(target, ast.Name):
            # local rebind; track manager aliases (mgr = self.kv_mgr)
            if isinstance(value, ast.Attribute) \
                    and value.attr in MANAGER_ATTRS:
                st.aliases[target.id] = value.attr
            else:
                st.aliases.pop(target.id, None)
            st.bindings[target.id] = value_handles
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) \
                    and len(value.elts) == len(target.elts):
                for t, v in zip(target.elts, value.elts):
                    self._assign_target(t, self._eval(v, st), v, st)
            else:
                for t in target.elts:
                    self._assign_target(t, value_handles, None, st)
            return
        if isinstance(target, ast.Attribute):
            if target.attr == "device_layers":
                if value is not None and isinstance(value, ast.Constant) \
                        and value.value is None:
                    # dropping the staging copy releases it
                    for h, status in st.status.items():
                        if h.kind == "staged" and status == HELD:
                            st.status[h] = RELEASED
                else:
                    # storing a device copy ACQUIRES a staged handle;
                    # only the staging registry (or a None store)
                    # discharges it
                    h = _Handle("staged", target.lineno)
                    st.status[h] = TRANSFERRED \
                        if self._owner_annotated(target.lineno) else HELD
                return
            # store into an object's attribute: the object owns it
            for h in value_handles:
                if st.status.get(h) == HELD:
                    st.status[h] = TRANSFERRED
            return
        if isinstance(target, ast.Subscript):
            base = target.value
            if isinstance(base, ast.Attribute) and base.attr == "_staged":
                # the staging registry claims every held staged copy
                for h, status in st.status.items():
                    if h.kind == "staged" and status == HELD:
                        st.status[h] = TRANSFERRED
            for h in value_handles:
                if st.status.get(h) == HELD:
                    st.status[h] = TRANSFERRED
            return

    # --------------------------------------------------- narrowing
    def _narrow(self, test: ast.expr, st_true: _State, st_false: _State
                ) -> None:
        """``if x is None`` / ``if x is not None`` on a name holding
        OPTIONAL handles: the None arm never acquired them."""
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1
                and isinstance(test.comparators[0], ast.Constant)
                and test.comparators[0].value is None
                and isinstance(test.left, ast.Name)):
            return
        var = test.left.id
        none_state = st_true if isinstance(test.ops[0], ast.Is) \
            else st_false
        for h in none_state.bindings.get(var, frozenset()):
            if h.optional and none_state.status.get(h) == HELD:
                none_state.status[h] = RELEASED

    # --------------------------------------------------- statements
    def _exec_stmts(self, stmts: List[ast.stmt], st: _State) -> _Flow:
        breaks: List[_State] = []
        continues: List[_State] = []
        cur: Optional[_State] = st
        for s in stmts:
            if cur is None:
                break
            flow = self._exec_stmt(s, cur)
            breaks.extend(flow.breaks)
            continues.extend(flow.continues)
            cur = flow.out
        return _Flow(cur, breaks, continues)

    def _exec_stmt(self, s: ast.stmt, st: _State) -> _Flow:
        if isinstance(s, ast.Return):
            hs = self._eval(s.value, st)
            for h in hs:
                if st.status.get(h) == HELD:
                    st.status[h] = TRANSFERRED
            if self._closure_returns:
                self._closure_returns[-1].append((st, hs))
            else:
                self._exit(st, s.lineno, "return")
            return _Flow(None, [], [])
        if isinstance(s, ast.Raise):
            if s.exc is not None:
                self._eval(s.exc, st)
            if not self._closure_returns:
                self._exit(st, s.lineno, "raise")
            return _Flow(None, [], [])
        if isinstance(s, ast.Break):
            self._leak_check(st, s.lineno, "break",
                             only=self._loop_local(st))
            return _Flow(None, [st], [])
        if isinstance(s, ast.Continue):
            self._leak_check(st, s.lineno, "continue",
                             only=self._loop_local(st))
            return _Flow(None, [], [st])
        if isinstance(s, ast.If):
            self._eval(s.test, st)
            st_true, st_false = st.clone(), st.clone()
            self._narrow(s.test, st_true, st_false)
            f_true = self._exec_stmts(s.body, st_true)
            f_false = self._exec_stmts(s.orelse, st_false)
            outs = [f for f in (f_true.out, f_false.out) if f is not None]
            return _Flow(_merge(outs) if outs else None,
                         f_true.breaks + f_false.breaks,
                         f_true.continues + f_false.continues)
        if isinstance(s, (ast.For, ast.AsyncFor)):
            self._check_window_collapse(s, st)
            iter_handles = self._eval(s.iter, st)
            self._assign_target(s.target, iter_handles, None, st)
            return self._exec_loop(s.body, s.orelse, st)
        if isinstance(s, ast.While):
            self._eval(s.test, st)
            return self._exec_loop(s.body, s.orelse, st)
        if isinstance(s, ast.Try):
            return self._exec_try(s, st)
        if isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                hs = self._eval(item.context_expr, st)
                if item.optional_vars is not None:
                    self._assign_target(item.optional_vars, hs,
                                        item.context_expr, st)
            return self._exec_stmts(s.body, st)
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if isinstance(s, ast.FunctionDef):
                self.local_defs[s.name] = s
            return _Flow(st, [], [])
        if isinstance(s, ast.Assign):
            hs = self._eval(s.value, st)
            for t in s.targets:
                self._assign_target(t, hs, s.value, st)
            return _Flow(st, [], [])
        if isinstance(s, ast.AnnAssign):
            if s.value is not None:
                hs = self._eval(s.value, st)
                self._assign_target(s.target, hs, s.value, st)
            return _Flow(st, [], [])
        if isinstance(s, ast.AugAssign):
            self._eval(s.value, st)
            return _Flow(st, [], [])
        if isinstance(s, ast.Expr):
            self._eval(s.value, st)
            return _Flow(st, [], [])
        if isinstance(s, ast.Assert):
            self._eval(s.test, st)
            return _Flow(st, [], [])
        if isinstance(s, ast.Delete):
            for t in s.targets:
                if isinstance(t, ast.Name):
                    st.bindings.pop(t.id, None)
            return _Flow(st, [], [])
        return _Flow(st, [], [])

    def _exec_loop(self, body: List[ast.stmt], orelse: List[ast.stmt],
                   st: _State) -> _Flow:
        entry = st.clone()
        self._loop_snapshots.append(set(st.status))
        flow = self._exec_stmts(body, st)
        self._loop_snapshots.pop()
        # after-loop = entry (zero iterations) ∪ one-iteration
        # fall-through ∪ continue states; break states join after else
        outs = [entry] + ([flow.out] if flow.out is not None else []) \
            + flow.continues
        merged = _merge(outs)
        if orelse:
            else_flow = self._exec_stmts(orelse, merged)
            merged = else_flow.out if else_flow.out is not None \
                else merged
        if flow.breaks:
            merged = _merge([merged] + flow.breaks)
        return _Flow(merged, [], [])

    def _exec_try(self, s: ast.Try, st: _State) -> _Flow:
        # handler entry: merge of per-statement contributions — BEFORE
        # simple statements (an acquire that raised never produced its
        # handle), AFTER compound ones (a partial allocation loop is
        # live when the handler runs)
        contributions: List[_State] = [st.clone()]
        breaks: List[_State] = []
        continues: List[_State] = []
        cur: Optional[_State] = st
        for sub in s.body:
            if cur is None:
                break
            if isinstance(sub, _SIMPLE_STMTS):
                contributions.append(cur.clone())
                flow = self._exec_stmt(sub, cur)
            else:
                flow = self._exec_stmt(sub, cur)
                if flow.out is not None:
                    contributions.append(flow.out.clone())
            breaks.extend(flow.breaks)
            continues.extend(flow.continues)
            cur = flow.out
        handler_entry = _merge(contributions)
        outs: List[_State] = []
        if cur is not None:
            if s.orelse:
                else_flow = self._exec_stmts(s.orelse, cur)
                breaks.extend(else_flow.breaks)
                continues.extend(else_flow.continues)
                if else_flow.out is not None:
                    outs.append(else_flow.out)
            else:
                outs.append(cur)
        for handler in s.handlers:
            hst = handler_entry.clone()
            if handler.name is not None:
                hst.bindings[handler.name] = frozenset()
            h_flow = self._exec_stmts(handler.body, hst)
            breaks.extend(h_flow.breaks)
            continues.extend(h_flow.continues)
            if h_flow.out is not None:
                outs.append(h_flow.out)
        merged: Optional[_State] = _merge(outs) if outs else None
        if s.finalbody:
            fin_in = merged if merged is not None else handler_entry
            fin_flow = self._exec_stmts(s.finalbody, fin_in)
            breaks.extend(fin_flow.breaks)
            continues.extend(fin_flow.continues)
            merged = fin_flow.out
        return _Flow(merged, breaks, continues)

    # ------------------------------------------- window-collapse check
    def _check_window_collapse(self, loop: ast.For, st: _State) -> None:
        """Flag a prefetch window computed as an occupancy complement
        (``... - len(...)``): a full engine makes it zero — exactly
        when prefetching for the queue head matters most."""
        bounds: List[ast.expr] = []
        it = loop.iter
        if isinstance(it, ast.Call):
            bounds.extend(it.args)
        else:
            bounds.append(it)
        suspicious = None
        for b in bounds:
            for node in ast.walk(b):
                if isinstance(node, ast.BinOp) \
                        and isinstance(node.op, ast.Sub):
                    has_len = any(
                        isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Name)
                        and n.func.id == "len"
                        for n in ast.walk(node.right))
                    if has_len:
                        suspicious = node
                        break
            if suspicious is not None:
                break
        if suspicious is None:
            return
        for node in ast.walk(loop):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _PREFETCH_METHODS:
                self.violations.append(Violation(
                    self.path, loop.lineno, "window-collapse",
                    f"{self.qn}: prefetch window bounded by an "
                    "occupancy complement ('... - len(...)') — a full "
                    "engine collapses the window to zero exactly when "
                    "the queue-head prefetch matters; bound it by a "
                    "config knob (e.g. admission_window) instead"))
                return

    # ------------------------------------------------------------- run
    def run(self, fn: ast.FunctionDef) -> None:
        st = _State()
        for sub in fn.body:
            if isinstance(sub, ast.FunctionDef):
                self.local_defs[sub.name] = sub
        flow = self._exec_stmts(
            [sub for sub in fn.body
             if not isinstance(sub, ast.FunctionDef)], st)
        if flow.out is not None:
            end = fn.body[-1].end_lineno or fn.body[-1].lineno
            self._exit(flow.out, end, "end of function")


# ---------------------------------------------------------------- checks
def _check_teardown(funcs: Dict[Tuple[Optional[str], str], _Func],
                    teardown: Dict[Tuple[Optional[str], str],
                                   FrozenSet[str]]
                    ) -> List[Violation]:
    out: List[Violation] = []
    for key, kinds in sorted(teardown.items()):
        if key not in funcs:
            out.append(Violation(
                "<lifecycle-tables>", 0, "lifecycle-table",
                f"teardown entry {_qualname(*key)} not found in the "
                "scanned sources — update the table"))
            continue
        fobj = funcs[key]
        found: Set[str] = set()
        for node in ast.walk(fobj.node):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            recv = node.func.value
            mgr = recv.attr if isinstance(recv, ast.Attribute) \
                and recv.attr in MANAGER_ATTRS else None
            method = node.func.attr
            if mgr == "kv_mgr" and method in ("release", "release_all"):
                found.add("kv")
            elif mgr == "st_mgr" and method == "release":
                found.add("state")
            elif mgr == "_free_slots" and method == "append":
                found.add("runslot")
            elif mgr == "adapter_pool" and method == "release":
                found.add("adapter")
        for kind in sorted(kinds - found):
            out.append(Violation(
                fobj.path, fobj.node.lineno, "teardown-missing",
                f"{_qualname(*key)}: per-request teardown never "
                f"releases the '{kind}' resource — a torn-down request "
                "would pin it for the engine's lifetime"))
    return out


def _check_owner_honesty(paths: Iterable[str],
                         owner_used: Set[Tuple[str, int]]
                         ) -> List[Violation]:
    out: List[Violation] = []
    for path in paths:
        with open(path) as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines, start=1):
            if OWNER_ANNOTATION in line and (path, i) not in owner_used:
                out.append(Violation(
                    path, i, "owner-unused",
                    f"'{OWNER_ANNOTATION}' annotation not attached to a "
                    "recognized acquire site — it silences nothing; "
                    "remove it or move it onto the acquire line"))
    return out


# ------------------------------------------------------------------ API
def check_files(paths: List[str], *,
                teardown: Optional[Dict[Tuple[Optional[str], str],
                                        FrozenSet[str]]] = None
                ) -> List[Violation]:
    """Run Pass C over ``paths``: the per-function lifecycle dataflow,
    the teardown-coverage check and the ``# owner:`` honesty audit."""
    teardown = TEARDOWN_FUNCS if teardown is None else teardown
    funcs = _index_functions(list(paths))
    violations: List[Violation] = []
    owner_used: Set[Tuple[str, int]] = set()
    for key in sorted(funcs, key=lambda k: (k[0] or "", k[1])):
        fobj = funcs[key]
        checker = _FunctionChecker(fobj, _qualname(*key), violations,
                                   owner_used)
        checker.run(fobj.node)
    violations.extend(_check_teardown(funcs, teardown))
    violations.extend(_check_owner_honesty(paths, owner_used))
    return violations


def check_tree(src_root: str) -> List[Violation]:
    """Run Pass C over the port's trees Pass B scans (``serving/``,
    ``kernels/`` and ``obs/``, the same files left out) with the default
    tables.  ``src_root`` is the directory containing ``repro_torch``."""
    pkg = os.path.join(src_root, "repro_torch")
    return check_files(
        _py_files(os.path.join(pkg, "serving"))
        + _py_files(os.path.join(pkg, "kernels"), KERNEL_EXEMPT_FILES)
        + _py_files(os.path.join(pkg, "obs"), OBS_EXPORT_FILES))
