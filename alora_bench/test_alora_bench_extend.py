"""A later change adds a mix, a cell and a per-layer metric as new files
and ``BENCHMARK.json`` entries alone: in a copy of the benchmark's data,
a new mix (an existing generator with other parameters), a cell that
runs it and a metric file that reads the run's record come out in the
cell's traced result line, with no file of the harness edited."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from alora_bench import harness, reduced

ROOT = Path(__file__).resolve().parents[1]

METRIC = '''"""Mean request rows of the window's mixed steps."""


def read(rec):
    lo, hi = rec.window
    rows = [c["R"] for c in rec.calls if lo <= c["t"] < hi]
    return sum(rows) / len(rows) if rows else None
'''


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_a_mix_a_cell_and_a_metric_from_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "alora_bench", tmp_path / "alora_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "*.py"))
    bench = tmp_path / "alora_bench"
    (bench / "gen").mkdir(exist_ok=True)
    for d in ("gen", "metrics"):
        for f in (ROOT / "alora_bench" / d).glob("*.py"):
            shutil.copy(f, bench / d)
    (bench / "mixes" / "chat-tiny.json").write_text(json.dumps({
        "generator": "independent", "why": "tiny chat prompts",
        "prompt": {"median": 24, "sigma": 0.3, "min": 8, "max": 48},
        "output": [2, 6], "adapter_share": 0.25}))
    (bench / "cells" / "granite-chat-tiny.json").write_text(json.dumps({
        "rate": 12.0, "limits": {"max_logit_gap": 1e-4}}))
    (bench / "metrics" / "decode_rows_mean.py").write_text(METRIC)
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "granite-chat-tiny",
                           "config": "granite-3.2-8b", "traffic": "chat-tiny",
                           "chips": 1, "why": "tiny chat prompts"})
    m["per_layer"].append({"name": "decode_rows_mean", "unit": "rows",
                           "better": "higher", "source": "program_counter",
                           "layer": "scheduler", "moves": "output_tok_s",
                           "workloads": ["granite-chat-tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    ov = {"config": reduced.OVERRIDES["config"],
          "cell": {k: v for k, v in reduced.OVERRIDES["cell"].items()
                   if k != "rate"}}
    result, _ = harness.run("granite-chat-tiny", 5, 1.0, True, device="cpu",
                            root=tmp_path, overrides=ov, reduced=True)
    assert result["correct"] is True
    assert result["metrics"]["decode_rows_mean"]["unit"] == "rows"
    assert result["metrics"]["decode_rows_mean"]["value"] >= 1.0
    assert "eval_reuse_pct" not in result["metrics"]
