"""Run one cell of the benchmark of ``repro_torch`` on this machine's card.

    python3 alora_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, and with ``--trace 1``
``breakdown``; the compared numbers beside their limits under
``checks``, last) and the compared numbers as the last lines of standard
error.  Exits non-zero, printing no result, without a CUDA card, when a
module of JAX or of the JAX package is loaded, or when the program is
not beside the benchmark.

``--control`` puts the control of the correctness check in the
program's place: the tokens that the float8 reference puts first are
judged instead of the served ones, so the run comes out not correct;
``--summary DIR`` writes the result to ``DIR/<cell>.<seed>.<trace>.json``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--summary", default=None)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be non-negative")

    # whatever the libraries below cache goes inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "build" / "triton_cache"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from alora_bench import harness, spec

    entry = spec.load(args.workload, ROOT)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry.chips:
        print(f"needs {entry.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, samples = harness.run(
        args.workload, args.seed, args.seconds, bool(args.trace),
        t_start=T_START, control=args.control)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {found}", file=sys.stderr)
        return 3
    if args.summary:
        out = Path(args.summary)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{args.workload}.{args.seed}.{args.trace}.json").write_text(
            json.dumps(dict(result, samples=samples)))
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
