"""The benchmark of ``repro_torch`` (the PyTorch and CUDA port): open-loop
traffic from data files against the port's serving engine on one card,
end-to-end metrics on the host clock, per-layer metrics from the port's
spans and counters and the profiler's device trace, and a check of the
served tokens against a plain float32 reference.  Run one cell with

    python3 alora_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
