"""The cells at the CPU tests' size: each configuration's reduced twin
(``repro_torch.configs.get_reduced``, float32, the kernels' plain
versions), two rank-8 adapters, short prompts and outputs, small pools,
and runs of about a second.  ``OVERRIDES`` merge into a cell's files
(``spec.load``); the compared limit is float32's."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the widest gap of a float32 served token: rounding alone
F32_GAP_LIMIT = 1e-4

OVERRIDES = {
    "config": {"adapters": {"count": 2, "rank": 8}, "ramp_s": 0.3,
               "drain_cap_s": 20},
    "mix": {"base_prompt": {"median": 48, "sigma": 0.5, "min": 16,
                            "max": 120},
            "base_output": [4, 8], "eval_output": [2, 4],
            "final_new_tokens": [2, 4], "final_output": [4, 6],
            "prompt": {"median": 40, "sigma": 0.5, "min": 8, "max": 100},
            "output": [4, 8]},
    "cell": {"rate": 8.0, "ramp_s": 0.3,
             "engine": {"num_blocks": 512, "max_running": 16,
                        "max_batched_tokens": 128, "num_state_slots": 64},
             "limits": {"max_logit_gap": F32_GAP_LIMIT}},
}

# The port's zamba2 (Mamba2 layers with an attention layer every 6th),
# at the test size only: no cell of the benchmark runs it, since its
# attention is narrower than the published Zamba2's.  The CPU tests run
# it as a cell of their own so that the harness's SSM path stays held:
# the reference's Mamba2 layers, a restored state snapshot, the faults
# of the SSM state.
SSM_CELL = "zamba2-rag-alora"
SSM_CONFIG = {            # the rest comes from ``OVERRIDES``
    "arch": "zamba2-2.7b",
    "adapters": {"invocation_tokens": 3, "b_std": 0.1},
    "engine": {"block_size": 16, "execution_mode": "mixed",
               "async_submission": True}}


def with_ssm_cell(root: Path) -> Path:
    """``root`` made a copy of the benchmark (its manifest and folder)
    with ``SSM_CELL`` added as a configuration file, a cell file and a
    workload entry."""
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "alora_bench", root / "alora_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = root / "alora_bench"
    (bench / "configs" / "zamba2-test.json").write_text(
        json.dumps(SSM_CONFIG))
    (bench / "cells" / f"{SSM_CELL}.json").write_text(json.dumps(
        {"rate": 1.0, "limits": {"max_logit_gap": F32_GAP_LIMIT}}))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "zamba2-test", "source": "test size only",
                         "file": "alora_bench/configs/zamba2-test.json",
                         "reduced": [], "why": "the harness's SSM path"})
    m["workloads"].append({"name": SSM_CELL, "config": "zamba2-test",
                           "traffic": "rag-alora-sessions", "chips": 1,
                           "why": "the harness's SSM path"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root
