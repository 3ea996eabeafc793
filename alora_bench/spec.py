"""What one cell runs, read from data files by name: ``BENCHMARK.json``'s
workload entry, its configuration file (``configs/<config>.json``), its
traffic mix (``mixes/<traffic>.json``, which names a generator in
``gen/``) and the cell's own file (``cells/<workload>.json``: its rate,
engine and mix settings, and the limits of its correctness check).
Adding a cell, a mix or a configuration adds files and entries; nothing
here changes."""
from __future__ import annotations

import copy
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def deep_merge(base: Dict, over: Optional[Dict]) -> Dict:
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


@dataclass
class CellSpec:
    name: str
    chips: int
    config: Dict[str, Any]          # the configuration file, merged
    mix: Dict[str, Any]             # the mix file, merged with the cell's
    cell: Dict[str, Any]            # the cell file
    engine: Dict[str, Any]          # EngineConfig fields
    bench: Path = BENCH             # where the data files were found
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def rate(self) -> float:
        return float(self.cell["rate"])

    @property
    def ramp_s(self) -> float:
        return float(self.cell.get("ramp_s", self.config["ramp_s"]))

    @property
    def drain_cap_s(self) -> float:
        return float(self.cell.get("drain_cap_s", self.config["drain_cap_s"]))


def read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def metric_applies(m: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in m or cell in m["workloads"]


def load(workload: str, root: Path = ROOT,
         overrides: Optional[Dict[str, Any]] = None) -> CellSpec:
    """The cell ``workload`` of ``root/BENCHMARK.json``.  ``overrides``
    ({"config": ..., "mix": ..., "cell": ...}, each merged into its file)
    serve the CPU tests' reduced runs."""
    manifest = read_json(root / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    ov = overrides or {}
    bench = root / BENCH.name
    config = deep_merge(read_json(root / conf["file"]), ov.get("config"))
    cell = deep_merge(read_json(bench / "cells" / f"{workload}.json"),
                      ov.get("cell"))
    mix = deep_merge(read_json(bench / "mixes" / f"{entry['traffic']}.json"),
                     cell.get("mix"))
    mix = deep_merge(mix, ov.get("mix"))
    engine = deep_merge(config["engine"], cell.get("engine"))
    e2e = [m for m in manifest["end_to_end"] if metric_applies(m, workload)]
    mine = {m["name"] for m in e2e}
    return CellSpec(
        name=workload, chips=int(entry["chips"]), config=config, mix=mix, cell=cell,
        engine=engine, bench=bench,
        end_to_end=e2e,
        # a per-layer metric without a list of cells belongs to every
        # cell that reports the end-to-end metric it moves
        per_layer=[m for m in manifest["per_layer"]
                   if (workload in m["workloads"] if "workloads" in m
                       else m["moves"] in mine)])


def load_module(path: Path):
    """Import one generator or metric file by its path."""
    name = "alora_bench_" + "".join(c if c.isalnum() else "_"
                                    for c in f"{path.parent.name}/{path.stem}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(cell: CellSpec):
    """The ``make`` function of the cell's generator file."""
    return load_module(cell.bench / "gen"
                       / f"{cell.mix['generator']}.py").make


def metric_file(bench: Path, name: str) -> Path:
    """Metric ``name``'s reader, ``metrics/<name>.py``.  A name with a
    suffix (``itl_p95_ms.<cell>``: the same quantity, moving another
    end-to-end metric in the cells it lists) reads with the file of the
    name before its first dot when it has none of its own."""
    path = bench / "metrics" / f"{name}.py"
    if not path.is_file():
        path = bench / "metrics" / f"{name.split('.')[0]}.py"
    return path


def metric_reader(cell: CellSpec, name: str):
    """The ``read`` function of metric ``name``'s reader."""
    return load_module(metric_file(cell.bench, name)).read
