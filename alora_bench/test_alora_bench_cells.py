"""Each cell end to end on the CPU at the reduced size (the kernels'
plain versions, about a second of traffic; with the tests' own zamba2
cell, ``reduced.with_ssm_cell``): one result line that keeps
the benchmark's contract, in both the plain and the traced run; and the
entry point's refusals (no card; the program missing)."""
from __future__ import annotations

import io
import json
import math
import shutil
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

from alora_bench import harness, reduced, spec

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def contract_errors(obj, cell: spec.CellSpec, trace: bool):
    """What in a result line breaks the contract (empty: nothing)."""
    errs = []
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        if k not in obj:
            errs.append(f"no {k}")
    if list(obj)[-1] != "checks":
        errs.append("checks is not the last key")
    want = {m["name"]: m["unit"]
            for m in (cell.per_layer if trace else cell.end_to_end)}
    for name, m in obj["metrics"].items():
        if want.get(name) != m["unit"] or set(m) != {"value", "unit"}:
            errs.append(f"metric {name}: {m}")
        elif not (isinstance(m["value"], float)
                  and math.isfinite(m["value"])):
            errs.append(f"metric {name} value {m['value']!r}")
    dev = obj["device"]
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        if k not in dev:
            errs.append(f"device has no {k}")
    for name, c in obj["checks"].items():
        if set(c) != {"value", "limit"}:
            errs.append(f"check {name}: {c}")
    return errs


@pytest.fixture(scope="module")
def ssm_root(tmp_path_factory):
    return reduced.with_ssm_cell(tmp_path_factory.mktemp("bench"))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS + [reduced.SSM_CELL])
def test_cell_runs_on_the_cpu(cell, trace, ssm_root):
    root = ssm_root if cell == reduced.SSM_CELL else ROOT
    result, samples = harness.run(cell, 98765432109, 2.0, trace,
                                  device="cpu", root=root,
                                  overrides=reduced.OVERRIDES, reduced=True)
    out = io.StringIO()
    with redirect_stdout(out):
        harness.report(result)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    sp = spec.load(cell, root, reduced.OVERRIDES)
    assert contract_errors(line, sp, trace) == []
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 3 and line["failed"] == 0
    names = set(line["metrics"])
    if trace:
        # the device's metrics need the card's profiler; the rest are read
        assert names == {m["name"] for m in sp.per_layer
                         if m["source"] != "device_trace"}
    else:
        assert names == {m["name"] for m in sp.end_to_end}
    assert len(samples["ttft_ms"]) == line["attempted"]


def test_run_refuses_without_a_card(tmp_path):
    """No card: a non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, str(ROOT / "alora_bench" / "run.py"),
                        "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's files
    cannot run: a non-zero exit and no result line."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "alora_bench", tmp_path / "alora_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "alora_bench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_compare_whole_names():
    assert harness.forbidden_modules(["repro_torch.serving", "jaxtyping",
                                      "torch"]) == []
    assert harness.forbidden_modules(["repro.serving.engine", "jax.numpy",
                                      "flax"]) == ["flax", "jax", "repro"]
