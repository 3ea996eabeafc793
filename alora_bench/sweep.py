"""The rate sweep that sets a cell's arrival rate: at each rate of
``--rates``, the cell's traffic on a fresh engine (the same weights),
``--ramp`` seconds, then ``--seconds`` during which the waiting queue is
sampled before every step.  One JSON line per rate on standard error and
all of them on standard output.

    python3 alora_bench/sweep.py --workload <cell> --seed <n> --rates 1,2,3
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--ramp", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from alora_bench import harness
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    rows = harness.sweep(args.workload, args.seed,
                         [float(r) for r in args.rates.split(",")],
                         args.seconds, args.ramp)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
