"""The dry run of the port: every (architecture × input shape) step on
the production meshes, sized one rank at a time, with no ranks and no
card — the counterpart of the reference's ``repro/launch/dryrun.py``.

The reference lowers and compiles each step for 256 or 512 TPU devices
and reads XLA's memory and cost analyses.  The port has no compiler
between it and the card, and a production mesh needs 256 or 512 live
ranks, so the dry run is shape arithmetic on ``{axis: size}`` meshes
(16×16 and 2×16×16) over ``launch.steps.build_step``'s per-rank meta
trees, the port's real layout (``RankLayout.local_shape``, ZeRO-1
blocks, the rank's rows of the batch, the K/V heads its query heads
read):

* memory: the rank's argument and output bytes — params, adapters,
  caches, the train state with its ZeRO-1 moments, the batch — against
  one H100's 80 GB.  Activations are NOT estimated (there is no XLA
  ``memory_analysis``): ``temp_size_in_bytes`` is null and the report
  prints "–";
* collectives: the list the port's step runs
  (``hlo_analysis.step_collectives``; in place of the reference's
  ``parse_collectives`` over HLO text);
* roofline: ``hlo_analysis.Roofline`` on the H100 data sheet's rates
  from the rank's operations (``step_flops``), bytes (arguments and
  outputs; a decode step's caches once) and collectives.

Usage:
  python -m repro_torch.launch.dryrun --arch stablelm-12b --shape train_4k
  python -m repro_torch.launch.dryrun --all            # both meshes
  python -m repro_torch.launch.dryrun --arch mamba2-2.7b --shape long_500k \\
      --mesh multipod

``--all`` appends the single-pod records to
``results/torch/dryrun_all.jsonl`` and the multi-pod ones to
``results/torch/dryrun_multipod.jsonl`` (``--out`` appends everything to
one file instead); ``python -m repro_torch.benchmarks.report`` renders
them.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Sequence

from repro_torch.common import tree_leaves
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, get_config,
                                 get_input_shape)
from repro_torch.launch.hlo_analysis import (HBM_BYTES, PEAK_FLOPS,
                                             PEAK_FLOPS_FP32, Roofline,
                                             collective_stats,
                                             model_flops_for,
                                             step_collectives, step_flops)
from repro_torch.launch.steps import build_step, make_runtime

RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "..", "results", "torch")
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def tree_nbytes(tree) -> int:
    """Bytes of a tree of (meta) tensors."""
    return sum(math.prod(t.shape) * t.element_size()
               for t in tree_leaves(tree))


def memory_record(spec) -> Dict[str, Any]:
    """The rank's bytes by kind: arguments and outputs of the step."""
    loc = spec.local
    parts: Dict[str, int] = {}
    if "state" in loc:
        st = loc["state"]
        parts["params"] = tree_nbytes(st["params"])
        parts["opt_state"] = tree_nbytes([st["mu"], st["nu"], st["step"]])
        parts["batch"] = tree_nbytes(loc["batch"])
        args = parts["params"] + parts["opt_state"] + parts["batch"]
    else:
        parts["params"] = tree_nbytes(loc["params"])
        parts["adapters"] = tree_nbytes(loc["adapters"])
        parts["inputs"] = tree_nbytes([v for k, v in loc.items() if k not in
                                       ("params", "adapters", "caches")])
        parts["caches"] = tree_nbytes(loc.get("caches", []))
        args = sum(parts.values())
    out = tree_nbytes(spec.outputs)
    return {"argument_size_in_bytes": args, "output_size_in_bytes": out,
            "temp_size_in_bytes": None,
            "generated_code_size_in_bytes": None, **{
                f"{k}_bytes": v for k, v in parts.items()}}


def run_one(arch: str, shape_name: str, mesh_name: str = "16x16",
            rt_overrides: Optional[Dict[str, Any]] = None,
            verbose: bool = True, mesh: Optional[Dict[str, int]] = None
            ) -> dict:
    """One record: the rank's memory, collectives and roofline of
    ``arch``'s ``shape_name`` step on ``mesh`` (default: the named
    production mesh)."""
    cfg = get_config(arch)
    shape = get_input_shape(shape_name)
    mesh = dict(mesh or MESHES[mesh_name])
    chips = math.prod(mesh.values())
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "ok": False}
    t0 = time.time()
    try:
        rt = make_runtime(cfg, mesh, shape, **(rt_overrides or {}))
        spec = build_step(cfg, shape, mesh, rt=rt)
        rec["memory"] = mem = memory_record(spec)
        per_rank = mem["argument_size_in_bytes"] \
            + mem["output_size_in_bytes"] * (not spec.donate_argnums)
        rec["hbm_limit_bytes"] = HBM_BYTES
        rec["fits_without_activations"] = per_rank <= HBM_BYTES
        coll = step_collectives(cfg, shape.mode, shape.global_batch,
                                shape.seq_len, mesh, rt)
        stats = collective_stats(coll)
        roof = Roofline(
            flops=step_flops(cfg, shape.mode, shape.global_batch,
                             shape.seq_len, mesh, rt,
                             window=rt.window_override),
            # a decode step writes one slot of its caches, in place
            hbm_bytes=mem["argument_size_in_bytes"]
            + mem["output_size_in_bytes"]
            - (mem.get("caches_bytes", 0) if shape.mode == "decode" else 0),
            collective=stats, chips=chips,
            model_flops=model_flops_for(cfg, shape),
            peak_flops=PEAK_FLOPS if cfg.dtype == "bfloat16"
            else PEAK_FLOPS_FP32)
        rec["roofline"] = roof.summary()
        rec["collectives"] = {"by_kind": stats.by_kind,
                              "counts": stats.counts,
                              "by_axis": _by_axis(coll)}
        rec["runtime"] = {"moe_impl": rt.moe_impl, "remat": rt.remat,
                          "window_override": rt.window_override,
                          "context_parallel": rt.context_parallel}
        rec["compile_s"] = round(time.time() - t0, 3)
        rec["ok"] = True
        if verbose:
            r = rec["roofline"]
            print(f"[OK] {arch:24s} {shape_name:12s} {mesh_name:8s} "
                  f"compute={r['compute_s']:.3e}s "
                  f"memory={r['memory_s']:.3e}s "
                  f"collective={r['collective_s']:.3e}s "
                  f"dominant={r['dominant']:10s} "
                  f"useful={r['useful_flops_ratio']:.2f}")
            print(f"     args/rank={mem['argument_size_in_bytes'] / 2**30:.2f}"
                  f"GiB out/rank={mem['output_size_in_bytes'] / 2**30:.2f}GiB"
                  f" temp/rank=– (not estimated)")
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[FAIL] {arch} {shape_name} {mesh_name}: {rec['error']}")
    return rec


def _by_axis(entries) -> Dict[str, Dict[str, int]]:
    out: Dict[str, Dict[str, int]] = {}
    for kind, axis, nbytes in entries:
        a = out.setdefault(f"{kind}/{axis}", {"count": 0, "bytes": 0})
        a["count"] += 1
        a["bytes"] += nbytes
    return out


def _overrides(pairs: Sequence[str]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default=None,
                    choices=["pod", "multipod", "both"],
                    help="default: both with --all, else pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help="append every JSONL record here")
    ap.add_argument("--set", action="append", default=[],
                    help="Runtime override, e.g. --set capacity_factor=1.0 "
                         "(repeatable)")
    ap.add_argument("--tag", default=None,
                    help="label recorded with the result (variants)")
    args = ap.parse_args(argv)
    overrides = _overrides(args.set)
    archs = ASSIGNED_ARCHS if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    mesh_arg = args.mesh or ("both" if args.all else "pod")
    meshes = {"pod": ["16x16"], "multipod": ["2x16x16"],
              "both": ["16x16", "2x16x16"]}[mesh_arg]
    n_ok = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for m in meshes:
                rec = run_one(arch, shape, m, rt_overrides=overrides)
                if args.tag:
                    rec["tag"] = args.tag
                    rec["overrides"] = overrides
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
                path = args.out
                if path is None and args.all:
                    path = os.path.join(RESULTS, "dryrun_all.jsonl"
                                        if m == "16x16"
                                        else "dryrun_multipod.jsonl")
                if path:
                    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                    rec.pop("traceback", None)
                    with open(path, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    print(f"\ndry-run: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
