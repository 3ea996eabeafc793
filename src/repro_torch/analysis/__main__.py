"""CLI for the port's invariant analyzer: ``python -m repro_torch.analysis``.

Runs the hot-path lint (Pass B) and the resource-lifecycle check (Pass
C) — both pure AST, a second or two — over the port's tree, or over
``--lint-paths``, then the step audit (Pass A: one traced mixed step
per config × mesh, ``analysis.step_audit``) on ``--device`` (the card
by default; without one it raises unless ``--device cpu`` or
``--skip-audit`` is given).  Exits 1 on any violation or fingerprint
drift (printed to stderr), else 0.

Artifacts in ``--out`` (default ``<repo>/results/torch``):
``analysis_audit.jsonl`` gains one record per audited config × mesh
(and, with ``--json``, one summary record per static pass);
``analysis_lifecycle.txt`` and ``analysis_fingerprint_diff.txt`` hold
the lifecycle violations and the collective drift, and are removed when
a later run is clean.  ``--update-goldens --device cpu`` rewrites the
checked-in collective goldens instead of diffing against them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Sequence


def _repo_paths():
    here = os.path.dirname(os.path.abspath(__file__))  # src/repro_torch/analysis
    src = os.path.dirname(os.path.dirname(here))
    return os.path.dirname(src), src                   # (repo root, src/)


def _artifact(path: str, text: str) -> None:
    """Write ``text`` to ``path``, or remove a stale ``path`` when it is
    empty, so a green run never leaves a red artifact behind."""
    if text:
        with open(path, "w") as f:
            f.write(text)
    elif os.path.exists(path):
        os.remove(path)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static invariant analyzer of the port: hot-path lint "
                    "(Pass B) + resource-lifecycle check (Pass C) + step "
                    "audit (Pass A)")
    ap.add_argument("--configs", default=None,
                    help="comma-separated arch names (default: all)")
    ap.add_argument("--meshes", default=None,
                    help="comma-separated mesh names (default: 1x1,2x4)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu' for the step audit")
    ap.add_argument("--update-goldens", action="store_true",
                    help="rewrite the collective-fingerprint goldens "
                         "instead of diffing against them")
    ap.add_argument("--skip-audit", action="store_true",
                    help="run only the lint and the lifecycle check")
    ap.add_argument("--skip-lint", action="store_true",
                    help="run only the step audit")
    ap.add_argument("--lint-paths", nargs="*", default=None,
                    help="check these files instead of the port's tree "
                         "(fixture/debug mode)")
    ap.add_argument("--out", default=None,
                    help="results directory for analysis_audit.jsonl, "
                         "analysis_lifecycle.txt and "
                         "analysis_fingerprint_diff.txt (default: "
                         "<repo>/results/torch)")
    ap.add_argument("--json", action="store_true",
                    help="append one summary record per static pass "
                         "(hotpath_lint, lifecycle_check) to "
                         "analysis_audit.jsonl")
    args = ap.parse_args(argv)

    repo_root, src = _repo_paths()
    out_dir = args.out or os.path.join(repo_root, "results", "torch")
    os.makedirs(out_dir, exist_ok=True)
    audit_path = os.path.join(out_dir, "analysis_audit.jsonl")
    failed = False

    if not args.skip_lint:
        from repro_torch.analysis.hotpath_lint import lint_files, lint_tree
        from repro_torch.analysis.lifecycle_check import (check_files,
                                                          check_tree)
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
        failed |= bool(violations) or bool(lifecycle)
        _artifact(os.path.join(out_dir, "analysis_lifecycle.txt"),
                  "".join(f"{v}\n" for v in lifecycle))
        if args.json:
            with open(audit_path, "a") as f:
                for kind, vs in (("hotpath_lint", violations),
                                 ("lifecycle_check", lifecycle)):
                    f.write(json.dumps({
                        "kind": kind, "ok": not vs, "n_violations": len(vs),
                        "violations": [str(v) for v in vs]}) + "\n")

    if not args.skip_audit:
        from repro_torch.analysis import step_audit
        from repro_torch.common import resolve_device
        device = resolve_device(args.device)
        results = step_audit.audit_all(
            args.configs.split(",") if args.configs else None,
            args.meshes.split(",") if args.meshes else None,
            device=device, update_goldens=args.update_goldens,
            progress=lambda msg: print(f"[audit] {msg}", flush=True))
        with open(audit_path, "a") as f:
            for r in results:
                f.write(json.dumps(r.to_json()) + "\n")
        diff = "".join(r.fingerprint_diff for r in results)
        _artifact(os.path.join(out_dir, "analysis_fingerprint_diff.txt"),
                  diff)
        if diff:
            print(diff, file=sys.stderr)
        bad = [r for r in results if not r.ok]
        for r in bad:
            for v in r.violations:
                print(f"{r.arch} [{r.mesh}]: {v}", file=sys.stderr)
        for r in results:
            for a in r.allowed:
                print(f"[audit] {r.arch} [{r.mesh}]: {a}")
        print(f"[audit] {len(results)} step(s) audited on {device.type}, "
              f"{len(bad)} failing")
        failed |= bool(bad)

    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
