"""Benchmark harness of the port — one section per paper table/figure,
the reference's ``benchmarks/run.py`` without ``fig6`` (the prompt-length
sweep: ROADMAP A16a); ``mixed_batch_tp`` is ``bench_mixed_batch --mesh
model=2``; ``roofline`` prints the dry run's table
(``repro_torch.launch.dryrun --all`` writes it).

Prints ``name,us_per_call,derived`` CSV rows, then each section's wall
time.

  PYTHONPATH=src python -m repro_torch.benchmarks.run            # all
  PYTHONPATH=src python -m repro_torch.benchmarks.run fig8 fig11 # subset
  PYTHONPATH=src python -m repro_torch.benchmarks.run --device cpu fig11

On the card by default; ``--device cpu`` runs the plain versions.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional, Sequence


def sections() -> Dict[str, Callable]:
    """Section name → ``run(device=...)``."""
    from repro_torch.benchmarks import (bench_adapter_base, bench_async,
                                        bench_batch_size,
                                        bench_generation_length,
                                        bench_mixed_batch,
                                        bench_multi_adapter)
    from repro_torch.benchmarks import roofline
    from repro_torch.kernels import bench as bench_kernels
    return {
        "mixed_batch": bench_mixed_batch.run,  # unified step vs sequential
        # the same, plus the tensor-parallel leg on 2 ranks (model=2)
        "mixed_batch_tp": lambda device: bench_mixed_batch.run(
            device=device, mesh={"data": 1, "model": 2}),
        "fig11": bench_adapter_base.run,       # adapter->base
        "fig10": bench_generation_length.run,  # generation-length sweep
        "fig8": bench_async.run,               # async Poisson (+fig9)
        "sec441": bench_multi_adapter.run,     # 5 parallel adapters
        "fig15": bench_batch_size.run,         # batch-size effect
        "kernels": lambda device: bench_kernels.run(
            str(device), reduced=str(device) == "cpu"),
        "roofline": roofline.run,              # dry-run roofline table
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    table = sections()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sections", nargs="*",
                    help=f"sections to run (default: all): {list(table)}")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    unknown = set(args.sections) - set(table)
    if unknown:
        ap.error(f"unknown sections {sorted(unknown)}")
    print("name,us_per_call,derived")
    for name in args.sections or list(table):
        t0 = time.time()
        table[name](device=args.device)
        print(f"section/{name}/wall_s,{(time.time()-t0)*1e6:.0f},")


if __name__ == "__main__":
    main()
