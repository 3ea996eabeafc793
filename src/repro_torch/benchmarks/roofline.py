"""Roofline table from the port's dry-run artifacts, the counterpart of
the reference's ``benchmarks/roofline.py``.

Reads ``results/torch/dryrun_all.jsonl`` (written by
``python -m repro_torch.launch.dryrun --all``) and prints per (arch ×
shape × mesh): the three roofline terms on the H100 data sheet's rates,
the dominant one, the MODEL_FLOPS / counted-operations ratio and the
rank's argument bytes (its activations are not estimated).
"""
from __future__ import annotations

import json
import os

from repro_torch.benchmarks.common import RESULTS

DEFAULT_PATH = os.path.join(RESULTS, "dryrun_all.jsonl")


def load(path=DEFAULT_PATH):
    recs = {}
    if not os.path.exists(path):
        return recs
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            recs[(r["arch"], r["shape"], r["mesh"])] = r  # last wins
    return recs


def run(path=DEFAULT_PATH, device=None):
    """``device`` is accepted for ``benchmarks.run``'s sections and
    unused: the dry run is shape arithmetic."""
    recs = load(path)
    if not recs:
        print(f"roofline/no-data,0.0,run repro_torch.launch.dryrun --all "
              f"first ({path} missing)")
        return
    n_ok = sum(1 for r in recs.values() if r.get("ok"))
    print(f"roofline/summary,0.0,{n_ok}/{len(recs)} combos sized OK")
    for (arch, shape, mesh), r in sorted(recs.items()):
        if not r.get("ok"):
            print(f"roofline/{arch}/{shape}/{mesh},0.0,"
                  f"FAILED: {r.get('error', '?')[:80]}")
            continue
        ro = r["roofline"]
        print(f"roofline/{arch}/{shape}/{mesh},"
              f"{max(ro['compute_s'], ro['memory_s'], ro['collective_s'])*1e6:.1f},"
              f"compute={ro['compute_s']:.3e} memory={ro['memory_s']:.3e} "
              f"collective={ro['collective_s']:.3e} "
              f"dominant={ro['dominant']} "
              f"useful={ro['useful_flops_ratio']:.2f} "
              f"args_gib={r['memory']['argument_size_in_bytes']/2**30:.1f} "
              f"temp_gib=–")


if __name__ == "__main__":
    run()
