"""Hot-path lint (Pass B of the invariant analyzer), the reference's
``repro/analysis/hotpath_lint.py`` fitted to PyTorch: an AST pass over
``serving/`` + ``kernels/`` + ``obs/`` enforcing the phase discipline of
the async step pipeline.

The serving iteration is schedule → submit → retire.  Schedule and
submit must never block on the device — the whole point of the pipeline
is that step N's host work hides under step N-1's device compute — so
inside ``Engine.step``'s call graph:

  B1  a host sync is forbidden in schedule/submit-phase functions.  The
      torch sync kinds are: ``.item()``, ``.tolist()``, ``.cpu()`` and
      ``.to("cpu")`` / ``.to(torch.device("cpu"))`` (device → host);
      ``torch.cuda.synchronize()`` and ``.synchronize()`` on an event or
      a stream; and a blocking host → device copy — ``.to(<device>)`` or
      ``.cuda()`` without ``non_blocking=True``, and ``torch.as_tensor``
      / ``torch.tensor`` given a ``device=`` (PyTorch waits for a copy
      from pageable memory to land).  ``.numpy()`` is not a kind of its
      own: it raises on a CUDA tensor, so the sync is the ``.cpu()`` in
      front of it.  Syncs are allowed in retire-phase functions (the one
      sanctioned sync per iteration) and on the sequential-oracle path,
      or at sites annotated ``# hotpath: sync-ok`` — and every annotated
      site's function must route the transfer through the ``log_d2h``
      logger so benchmarks can still account for it.
  B2, B3  (eager ``jnp`` dispatch outside jit; ``time.*`` inside jit)
      have no counterpart while the port's step is eager: every torch op
      is its own dispatch by design, and nothing is captured.  They
      return with the captured step alone (ROADMAP A8; Pass A, the step
      audit, has landed and checks the eager step meanwhile).
  B4  trace recording (``repro_torch.obs.tracer``, reached from the hot
      graph through ``self.tracer.*``) must be append-only plain python:
      EVERY function in the obs recording files is checked wholesale —
      any ``torch.*`` call (``obs-torch``) or sync kind (``obs-sync``) is
      a violation, with no ``sync-ok`` annotation escape.  Exporters
      (``obs/export.py``) are exempt: they never run on the step path.
  B5  phase protocol: the value-dependent state mutations deferred to
      the retire phase (``_finish_requests``, decode hash-chain
      extension, decode-block registration, preemption — the RETIRE_ONLY
      table) must be *unreachable* from schedule/submit-phase code.  A
      resolvable hot-graph call site to one of them is a
      ``phase-retire-only`` violation unless the line is annotated
      ``# phase: retire-ok (<reason>)`` — sanctioned sites are the
      drain-guarded starvation preempt in ``Engine.step`` and the
      sync-oracle-only paths, where the value dependency is provably
      satisfied.  Annotations are audited: one not attached to a hot
      call site of a RETIRE_ONLY function is ``phase-stale``.

The call graph is intraprocedural over the scanned files: ``self.x()``
resolves within the class, ``self.<attr>.x()`` through the static
attribute table below (``runner`` → ModelRunner, ``adapter_pool`` →
AdapterPool, ...).  Functions named in the phase tables MUST exist in
the scanned sources — a stale entry is itself a lint error, so the
tables cannot silently rot.  Every function in ``kernels/`` is treated
as hot for B1 (a wrapper runs inside the step; a host sync there is
never right), except the plain versions: the port picks the kernel or
its plain version by the tensor's device, so a function named ``*_ref``
only ever runs on CPU tensors, where no sync exists.
``kernels/bench.py`` (the counterpart of the reference's
``benchmarks/bench_kernels.py``, which the reference never scans) and
``kernels/build.py`` (the nvcc build) run no step and are left out.

Fixture-level behaviour (each rule firing and not firing) is covered in
``tests/test_torch_analysis.py``; the same module also lints the real
tree.
"""
from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

SYNC_OK_ANNOTATION = "hotpath: sync-ok"
PHASE_OK_ANNOTATION = "phase: retire-ok"
D2H_LOGGER = "log_d2h"
# plain versions in kernels/: run only on CPU tensors (dispatch by device)
REF_SUFFIX = "_ref"

# (class, function) sets defining the retire phase (the sanctioned sync
# point) and the sequential-oracle path (synchronous by definition).
# Traversal stops at these: their callees inherit the exemption.
RETIRE_PHASE: Set[Tuple[str, str]] = {
    ("Engine", "_retire"),
    ("Engine", "_register_decode_block"),
    ("Engine", "_finish_requests"),
    ("ModelRunner", "fetch_sampled"),
}
SEQUENTIAL_ORACLE: Set[Tuple[str, str]] = {
    ("Engine", "_execute_decodes"),
    ("Engine", "_execute_prefills"),
    ("Engine", "_postprocess_decode"),
    ("Engine", "_postprocess_prefill"),
    ("ModelRunner", "execute_batch"),
    ("ModelRunner", "decode_batch"),
    ("ModelRunner", "prefill_chunk"),
}
# B5: value-dependent retire-phase mutations that schedule/submit code
# must never reach — patching PENDING placeholders, extending the
# decode hash chain, registering decode blocks and preempting all
# require token VALUES the async pipeline has not synced yet.  Hot
# call sites to these need an explicit ``# phase: retire-ok`` waiver.
RETIRE_ONLY: Set[Tuple[str, str]] = {
    ("Engine", "_finish_requests"),
    ("Engine", "_extend_hash_chain"),
    ("Engine", "_register_decode_block"),
    ("Engine", "_preempt"),
}
# instance-attribute → class resolution for cross-object calls
ATTR_CLASSES: Dict[str, str] = {
    "runner": "ModelRunner",
    "adapter_pool": "AdapterPool",
    "host_bufs": "HostBufferPool",
    "cache": "PrefixCache",
    "tracer": "Tracer",
    "tp": "TensorParallel",
}
# obs files exempt from the wholesale B4 recording rule: exporters run
# strictly off the step path (after a run / from a CLI), so they may do
# real work — everything else under obs/ is recording surface
OBS_EXPORT_FILES = frozenset({"export.py"})
# kernels/ files exempt from the kernel-wide B1 rule: the kernel bench
# (the counterpart of the reference's benchmarks/bench_kernels.py, which
# the reference never scans) and the nvcc build run no serving step
KERNEL_EXEMPT_FILES = frozenset({"bench.py", "build.py"})
# Router.submit is the multi-replica ADMIT path: every placement probes
# N replicas (prefix-cache walk + residency snapshot + load read), so a
# hidden device sync there would multiply by the fleet size per request.
# Router.step fans one fleet step out over every live replica — it rides
# the same no-sync budget as Engine.step, whose graph it contains.  The
# router reaches the replica-surface probes through local variables the
# intraprocedural resolver cannot follow, so those probes are rooted
# explicitly alongside Engine.submit (which Router.submit delegates to).
ROOTS: Tuple[Tuple[str, str], ...] = (
    ("Engine", "step"),
    ("Router", "submit"),
    ("Router", "step"),
    ("Engine", "submit"),
    ("Engine", "cached_prefix_tokens"),
    ("Engine", "outstanding_tokens"),
    ("Engine", "adapter_residency"),
    ("Engine", "adapter_affinity"),
    # admission paths, rooted explicitly so B1 coverage survives
    # refactors that break the intraprocedural resolution (e.g. a local
    # ``pool = self.adapter_pool`` receiver)
    ("Engine", "_admit_affinity"),
    ("AdapterPool", "tick"),
    ("AdapterPool", "can_take_slot"),
    ("AdapterPool", "affinity_of"),
)


@dataclass(frozen=True)
class Violation:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class _Func:
    path: str
    node: ast.FunctionDef
    source_lines: List[str]


def _qualname(cls: Optional[str], name: str) -> str:
    return f"{cls}.{name}" if cls else name


def _index_functions(paths: List[str]) -> Dict[Tuple[Optional[str], str],
                                               _Func]:
    """Map (class-or-None, function-name) → definition for every file."""
    funcs: Dict[Tuple[Optional[str], str], _Func] = {}
    for path in paths:
        with open(path) as f:
            src = f.read()
        lines = src.splitlines()
        tree = ast.parse(src, filename=path)
        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                funcs[(None, node.name)] = _Func(path, node, lines)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef):
                        funcs[(node.name, sub.name)] = _Func(path, sub,
                                                             lines)
    return funcs


def _call_sites(cls: Optional[str], fn: ast.FunctionDef,
                attr_classes: Dict[str, str]
                ) -> List[Tuple[Tuple[Optional[str], str], int]]:
    """Resolvable call sites inside ``fn`` with their line numbers:
    ``self.x()`` → same class, ``self.<attr>.x()`` /
    ``<anything>.<attr>.x()`` → attr table."""
    out: List[Tuple[Tuple[Optional[str], str], int]] = []
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        base = node.func.value
        if isinstance(base, ast.Name) and base.id == "self" \
                and cls is not None:
            out.append(((cls, node.func.attr), node.lineno))
        elif isinstance(base, ast.Attribute) \
                and base.attr in attr_classes:
            out.append(((attr_classes[base.attr], node.func.attr),
                        node.lineno))
    return out


def _called_targets(cls: Optional[str], fn: ast.FunctionDef,
                    attr_classes: Dict[str, str]
                    ) -> List[Tuple[Optional[str], str]]:
    return [tgt for tgt, _ in _call_sites(cls, fn, attr_classes)]


def _reachable_hot(funcs, roots, stop, attr_classes
                   ) -> Set[Tuple[Optional[str], str]]:
    """BFS the call graph from ``roots``; do not descend into ``stop``
    entries (retire/oracle — allowed to sync, callees inherit)."""
    seen: Set[Tuple[Optional[str], str]] = set()
    frontier: List[Tuple[Optional[str], str]] = \
        [r for r in roots if r in funcs]
    while frontier:
        key = frontier.pop()
        if key in seen or key in stop:
            continue
        seen.add(key)
        fobj = funcs[key]
        for tgt in _called_targets(key[0], fobj.node, attr_classes):
            if tgt in funcs and tgt not in seen:
                frontier.append(tgt)
    return seen


def _dotted(expr: ast.expr) -> str:
    """``a.b.c`` of a Name/Attribute chain, else ''."""
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return ""
    parts.append(expr.id)
    return ".".join(reversed(parts))


def _is_cpu(expr: ast.expr) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str) and expr.value.startswith("cpu")
    return isinstance(expr, ast.Call) and _dotted(expr.func) == \
        "torch.device" and bool(expr.args) and _is_cpu(expr.args[0])


def _is_device(expr: ast.expr) -> bool:
    """An expression that names a device rather than a dtype or another
    tensor: a string, ``torch.device(...)``, or a name/attribute called
    ``device``/``dev`` (``self.device``, ``x.device``, ``dev``)."""
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str)
    if isinstance(expr, ast.Call):
        return _dotted(expr.func) == "torch.device"
    name = expr.attr if isinstance(expr, ast.Attribute) else \
        expr.id if isinstance(expr, ast.Name) else ""
    return name in ("dev", "device") or name.endswith("_device")


def _kwarg(node: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _non_blocking(node: ast.Call) -> bool:
    v = _kwarg(node, "non_blocking")
    return isinstance(v, ast.Constant) and v.value is True


def _sync_call_kind(node: ast.Call) -> Optional[str]:
    """Classify a call as one of the torch host-sync constructs."""
    f = node.func
    if not isinstance(f, ast.Attribute):
        return None
    bare = not node.args and not node.keywords
    if f.attr in ("item", "tolist", "cpu") and bare:
        return f".{f.attr}()"
    if f.attr == "synchronize":
        return "torch.cuda.synchronize()" \
            if _dotted(f.value) == "torch.cuda" else ".synchronize()"
    if f.attr == "cuda" and not _non_blocking(node) \
            and _dotted(f.value) != "torch":
        return "blocking .cuda()"
    if f.attr == "to":
        dev = _kwarg(node, "device")
        if dev is None and node.args and _is_device(node.args[0]):
            dev = node.args[0]
        if dev is None:
            return None                  # a dtype cast
        if _is_cpu(dev):
            return ".to('cpu')"
        if not _non_blocking(node):
            return "blocking .to(<device>)"
        return None
    if f.attr in ("as_tensor", "tensor") and _dotted(f.value) == "torch":
        dev = _kwarg(node, "device")
        if dev is not None and not _is_cpu(dev):
            return f"torch.{f.attr}(..., device=)"
    return None


def _annotated_at(lines: List[str], lineno: int,
                  marker: str) -> Optional[int]:
    """The 1-based line carrying ``marker`` if the source line (or the
    line above it — for call expressions wrapped across lines) does."""
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines) and marker in lines[ln - 1]:
            return ln
    return None


def _line_annotated(lines: List[str], lineno: int) -> bool:
    return _annotated_at(lines, lineno, SYNC_OK_ANNOTATION) is not None


def _calls_logger(fn: ast.FunctionDef) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id == D2H_LOGGER:
                return True
            if isinstance(f, ast.Attribute) and f.attr == D2H_LOGGER:
                return True
    return False


def _check_hot_function(key, fobj: _Func) -> List[Violation]:
    out: List[Violation] = []
    fn, lines = fobj.node, fobj.source_lines
    qn = _qualname(*key)
    logs = _calls_logger(fn)
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        kind = _sync_call_kind(node)
        if kind is None:
            continue
        if _line_annotated(lines, node.lineno):
            if not logs:
                out.append(Violation(
                    fobj.path, node.lineno, "sync-unlogged",
                    f"{qn}: '{SYNC_OK_ANNOTATION}' site ({kind}) in "
                    f"a function that never calls {D2H_LOGGER} — "
                    "annotated syncs must stay accountable in "
                    "d2h_fetches"))
        else:
            out.append(Violation(
                fobj.path, node.lineno, "hot-sync",
                f"{qn}: {kind} in a schedule/submit-phase function "
                "— blocks the async pipeline; move it to the retire "
                f"phase or annotate '# {SYNC_OK_ANNOTATION}' and "
                f"log via {D2H_LOGGER}"))
    return out


def _check_obs_function(key, fobj: _Func) -> List[Violation]:
    """B4: trace-recording code is append-only plain python — reject
    ANY torch call and every sync kind, annotation or not."""
    out: List[Violation] = []
    qn = _qualname(*key)
    for node in ast.walk(fobj.node):
        if not isinstance(node, ast.Call):
            continue
        kind = _sync_call_kind(node)
        if kind is not None:
            out.append(Violation(
                fobj.path, node.lineno, "obs-sync",
                f"{qn}: {kind} in trace-recording code — recording runs "
                "inside schedule/submit phases; it must stay append-only "
                "plain python (no annotation escape — move the work to "
                "repro_torch.obs.export)"))
        root = node.func
        while isinstance(root, ast.Attribute):
            root = root.value
        if isinstance(root, ast.Name) and root.id == "torch":
            out.append(Violation(
                fobj.path, node.lineno, "obs-torch",
                f"{qn}: {ast.unparse(node.func)}() in trace-recording "
                "code — no torch calls of any kind belong in the "
                "recording path; move the work to repro_torch.obs.export"))
    return out


def _check_phase_protocol(funcs, hot, retire_only, attr_classes,
                          paths) -> List[Violation]:
    """B5: flag resolvable hot-graph call sites into the RETIRE_ONLY
    table unless waived with ``# phase: retire-ok``, and audit every
    waiver so stale ones cannot silently widen the sanctioned set."""
    out: List[Violation] = []
    used: Set[Tuple[str, int]] = set()
    for key in sorted(hot, key=lambda k: (k[0] or "", k[1])):
        if key in retire_only:
            # retire-only functions may call each other freely
            continue
        fobj = funcs[key]
        qn = _qualname(*key)
        for tgt, lineno in _call_sites(key[0], fobj.node, attr_classes):
            if tgt not in retire_only:
                continue
            ann = _annotated_at(fobj.source_lines, lineno,
                                PHASE_OK_ANNOTATION)
            if ann is not None:
                used.add((fobj.path, ann))
            else:
                out.append(Violation(
                    fobj.path, lineno, "phase-retire-only",
                    f"{qn}: calls retire-only {_qualname(*tgt)} from "
                    "the schedule/submit phase — its bookkeeping needs "
                    "token values the async pipeline has not synced; "
                    "defer it to the retire phase or annotate "
                    f"'# {PHASE_OK_ANNOTATION} (<reason>)' if the "
                    "value dependency is provably satisfied here"))
    for path in paths:
        with open(path) as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines, start=1):
            if PHASE_OK_ANNOTATION in line and (path, i) not in used:
                out.append(Violation(
                    path, i, "phase-stale",
                    f"'{PHASE_OK_ANNOTATION}' annotation not attached "
                    "to a hot call site of a RETIRE_ONLY function — it "
                    "waives nothing; remove it (or the table entry it "
                    "once waived)"))
    return out


def lint_files(paths: List[str], *,
               kernel_paths: Tuple[str, ...] = (),
               obs_paths: Tuple[str, ...] = (),
               roots: Tuple[Tuple[str, str], ...] = ROOTS,
               retire: Optional[Set[Tuple[str, str]]] = None,
               oracle: Optional[Set[Tuple[str, str]]] = None,
               retire_only: Optional[Set[Tuple[str, str]]] = None,
               attr_classes: Optional[Dict[str, str]] = None
               ) -> List[Violation]:
    """Lint ``paths`` (call-graph rule B1 from ``roots``, phase protocol
    B5 against ``retire_only``) plus ``kernel_paths`` (B1 on every
    function but the ``*_ref`` plain versions) plus ``obs_paths`` (B4
    wholesale — trace recording is also indexed into the call graph, so
    hot-graph ``self.tracer.*`` calls resolve and get B1 on top)."""
    retire = RETIRE_PHASE if retire is None else retire
    oracle = SEQUENTIAL_ORACLE if oracle is None else oracle
    retire_only = RETIRE_ONLY if retire_only is None else retire_only
    attr_classes = ATTR_CLASSES if attr_classes is None else attr_classes
    funcs = _index_functions(list(paths) + list(obs_paths))
    ofuncs = _index_functions(list(obs_paths))
    kfuncs = _index_functions(list(kernel_paths))
    violations: List[Violation] = []
    # phase tables must describe code that exists — a stale entry would
    # silently widen (or shrink) the checked surface
    for label, table in (("retire", retire), ("oracle", oracle),
                         ("retire-only", retire_only),
                         ("root", set(roots))):
        for entry in sorted(table):
            if entry not in funcs:
                violations.append(Violation(
                    "<phase-tables>", 0, "phase-table",
                    f"{label} entry {_qualname(*entry)} not found in the "
                    "scanned sources — update the table"))
    stop = retire | oracle
    hot = _reachable_hot(funcs, roots, stop, attr_classes)
    for key in sorted(hot, key=lambda k: (k[0] or "", k[1])):
        violations.extend(_check_hot_function(key, funcs[key]))
    violations.extend(_check_phase_protocol(funcs, hot, retire_only,
                                            attr_classes, list(paths)))
    for key in sorted(kfuncs, key=lambda k: (k[0] or "", k[1])):
        if not key[1].endswith(REF_SUFFIX):
            violations.extend(_check_hot_function(key, kfuncs[key]))
    for key in sorted(ofuncs, key=lambda k: (k[0] or "", k[1])):
        violations.extend(_check_obs_function(key, ofuncs[key]))
    return violations


def _py_files(d: str, exclude=frozenset()) -> List[str]:
    if not os.path.isdir(d):
        return []
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".py") and f not in exclude)


def lint_tree(src_root: str) -> List[Violation]:
    """Lint the port's serving + kernels + obs trees (and the sharded
    step's collectives, ``distributed/parallel.py``) with the default
    tables.  ``src_root`` is the directory containing the
    ``repro_torch`` package."""
    pkg = os.path.join(src_root, "repro_torch")
    return lint_files(
        _py_files(os.path.join(pkg, "serving"))
        + [os.path.join(pkg, "distributed", "parallel.py")],
        kernel_paths=tuple(_py_files(os.path.join(pkg, "kernels"),
                                     KERNEL_EXEMPT_FILES)),
        obs_paths=tuple(_py_files(os.path.join(pkg, "obs"),
                                  OBS_EXPORT_FILES)))
