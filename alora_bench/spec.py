"""What one cell runs, read from data files by name: ``BENCHMARK.json``'s
workload entry, its configuration file (``configs/<config>.json``), its
traffic mix (``mixes/<traffic>.json``, which names a generator in
``gen/``), the cell's own file (``cells/<workload>.json``: its rate,
engine and mix settings, and the limits of its correctness check) and
the configuration's model family (``families/<family>.py``, with its
reference ``reference/<family>.py``).  Adding a cell, a mix or a
configuration adds files and entries; nothing here changes.

A model family is the harness's model code for one kind of model.  The
configuration file names it as ``"family": "<name>"``; without the key
it is ``stack`` (attention+SwiGLU and Mamba2 stacks).  Its module
provides five functions:

* ``config(spec, reduced)``: the port's ``ModelConfig`` of the cell's
  model, checked against the file's ``model`` block (``reduced``: the
  CPU tests' reduced twin, with the file's ``reduced_model`` changes);
* ``dims_of(cfg)``: the model's plain numbers, a dict.  The harness
  reads ``kinds`` (one entry a layer; each ``"attn"`` is one call of B1,
  paged attention, in a mixed step, each ``"ssm"`` one call of B3, the
  ragged SSD scan; other kinds are the family's own), ``num_heads``,
  ``num_kv_heads`` and ``head_dim`` (the shapes of B1's calls),
  ``ssm`` (``state_dim``, ``head_dim``) and ``ssm_heads`` (those of B3's,
  with any ``"ssm"`` layer), ``vocab_size`` (the traffic's ids lie
  below it) and ``dtype`` (``"bfloat16"`` or ``"float32"``: the served
  type, the bytes of B1's operands and the control's precision); the
  rest is the family's own;
* ``draw(dims, adapters, seed, device, segments)``: the weights and the
  configuration's ``adapters`` drawn on ``device`` from ``seed``, in the
  served type and in a few large calls (``weights.Flat``); ``segments``
  is the port's ``period_segments`` of the layer pattern.  Returns
  {"params": the port's parameter tree, "adapters": [(name, invocation
  ids from the top of the vocabulary, the port's adapter tree)],
  "layers": per layer, each adapter's weights as the reference reads
  them};
* ``reference(dims, weights, layers, device, quant=None)``: an object
  whose ``logits(seqs)`` gives the float32 logits of each
  ``reference.Seq`` at its ``want`` positions, over the drawn weights;
  ``quant`` ("fp8", "bf16") rounds every product's operands (the
  control, one precision below the configuration's);
* ``step_flops(call, dims, adapter_rank)``: the model FLOPs of one mixed
  step, from the traced run's summary of its batch (``T`` tokens, ``R``
  request rows, ``ctx`` the tokens' summed contexts, ``adapted`` rows,
  ``ssd_ops`` with SSM layers): what ``step_mfu`` counts.

The reference is plain PyTorch in ``reference/<family>.py`` (a subclass
of ``reference.common.Plain``): float32 with TF32 off, no kernel, cache
or batching of the program, and no import of the program
(``test_alora_bench_imports.py`` holds every file there to it).  It
follows the published equations, and each departure of the port from
them is written under ``departures`` in the configuration file.

To add a configuration: a configuration file (``arch``, ``model`` with
every number of its source, ``engine``, ``adapters``, ``ramp_s``,
``drain_cap_s``, ``family`` where it is not ``stack``), the family's two
files where no family fits it yet, a cell file, and the ``configs`` and
``workloads`` entries of ``BENCHMARK.json``.  A pair of configuration
and traffic appears in one cell only; a second cell of the same traffic
on one configuration names a mix file of its own.
"""
from __future__ import annotations

import copy
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
DEFAULT_FAMILY = "stack"


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
    family: Any = None              # the configuration's family module
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
    family = load_family(bench, config.get("family", DEFAULT_FAMILY))
    e2e = [m for m in manifest["end_to_end"] if metric_applies(m, workload)]
    mine = {m["name"] for m in e2e}
    return CellSpec(
        name=workload, chips=int(entry["chips"]), config=config, mix=mix, cell=cell,
        engine=engine, bench=bench, family=family,
        end_to_end=e2e,
        # a per-layer metric without a list of cells belongs to every
        # cell that reports the end-to-end metric it moves
        per_layer=[m for m in manifest["per_layer"]
                   if (workload in m["workloads"] if "workloads" in m
                       else m["moves"] in mine)])


def load_module(path: Path):
    """Import one generator, metric, family or reference file by its
    path."""
    name = "alora_bench_" + "".join(c if c.isalnum() else "_"
                                    for c in f"{path.parent.name}/{path.stem}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_file(family_file: Path) -> Path:
    """A family's reference: ``reference/<family>.py`` of the benchmark
    folder that holds ``families/<family>.py``."""
    family_file = Path(family_file)
    return family_file.parents[1] / "reference" / family_file.name


def reference_module(family_file: Path):
    """Import the reference of the family in ``family_file``."""
    return load_module(reference_file(family_file))


def load_family(bench: Path, name: str):
    """Import the family module ``name`` of the benchmark folder ``bench``;
    an unknown name fails here, before any weights or traffic."""
    path = bench / "families" / f"{name}.py"
    if not (path.is_file() and reference_file(path).is_file()):
        raise ValueError(f"model family {name!r}: families/{name}.py and "
                         f"reference/{name}.py are needed in {bench}")
    return load_module(path)


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
