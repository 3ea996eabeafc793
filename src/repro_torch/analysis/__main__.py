"""CLI for the port's invariant analyzer: ``python -m repro_torch.analysis``.

Runs the hot-path lint (Pass B) and the resource-lifecycle check (Pass
C) — both pure AST, a second or two — over the port's tree, or over
``--lint-paths``.  Exits 1 on any violation (printed to stderr), else 0.
A lifecycle violation also leaves ``analysis_lifecycle.txt`` in
``--out`` (removed when a later run is clean); ``--json`` appends one
summary record per pass to ``analysis_audit.jsonl`` there.  The
default ``--out`` is ``<repo>/results/torch``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Sequence

from repro_torch.analysis.hotpath_lint import lint_files, lint_tree
from repro_torch.analysis.lifecycle_check import check_files, check_tree


def _repo_paths():
    here = os.path.dirname(os.path.abspath(__file__))  # src/repro_torch/analysis
    src = os.path.dirname(os.path.dirname(here))
    return os.path.dirname(src), src                   # (repo root, src/)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static invariant analyzer of the port: hot-path lint "
                    "(Pass B) + resource-lifecycle check (Pass C)")
    ap.add_argument("--lint-paths", nargs="*", default=None,
                    help="check these files instead of the port's tree "
                         "(fixture/debug mode)")
    ap.add_argument("--out", default=None,
                    help="results directory for analysis_audit.jsonl and "
                         "analysis_lifecycle.txt (default: "
                         "<repo>/results/torch)")
    ap.add_argument("--json", action="store_true",
                    help="append one summary record per pass "
                         "(hotpath_lint, lifecycle_check) to "
                         "analysis_audit.jsonl")
    args = ap.parse_args(argv)

    repo_root, src = _repo_paths()
    out_dir = args.out or os.path.join(repo_root, "results", "torch")
    if args.lint_paths is not None:
        paths: List[str] = list(args.lint_paths)
        violations = lint_files(paths)
        lifecycle = check_files(paths)
    else:
        violations = lint_tree(src)
        lifecycle = check_tree(src)
    for v in violations:
        print(v, file=sys.stderr)
    print(f"[lint] {len(violations)} violation(s)")
    for v in lifecycle:
        print(v, file=sys.stderr)
    print(f"[lifecycle] {len(lifecycle)} violation(s)")
    # the violation artifact is removed when clean, so a green run never
    # leaves a stale red one behind
    os.makedirs(out_dir, exist_ok=True)
    lpath = os.path.join(out_dir, "analysis_lifecycle.txt")
    if lifecycle:
        with open(lpath, "w") as f:
            f.write("".join(f"{v}\n" for v in lifecycle))
    elif os.path.exists(lpath):
        os.remove(lpath)
    if args.json:
        with open(os.path.join(out_dir, "analysis_audit.jsonl"), "a") as f:
            for kind, vs in (("hotpath_lint", violations),
                             ("lifecycle_check", lifecycle)):
                f.write(json.dumps({
                    "kind": kind, "ok": not vs, "n_violations": len(vs),
                    "violations": [str(v) for v in vs]}) + "\n")
    return 1 if violations or lifecycle else 0


if __name__ == "__main__":
    sys.exit(main())
