"""``BENCHMARK.json`` keeps the benchmark's contract: its keys, names,
units and lengths; each configuration used and its file under the
benchmark's path; each per-layer metric moving an end-to-end metric
that every cell it lists reports; every cell with ``setup_s``, another
end-to-end metric and a per-layer metric; a reader file for every
metric (its own, or that of the name before its first dot) and a cell
file for every cell."""
from __future__ import annotations

import json
import re
from pathlib import Path

from alora_bench import spec

ROOT = Path(__file__).resolve().parents[1]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_entries():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "alora_bench/run.py"]
    assert M["paths"] == ["alora_bench"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["why"])
        assert one_line(c["source"]) and c["file"].startswith("alora_bench/")
        assert (ROOT / c["file"]).is_file() and len(c["reduced"]) <= 16
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and one_line(w["why"])
        assert (ROOT / "alora_bench" / "cells" / f"{w['name']}.json").is_file()
        assert (ROOT / "alora_bench" / "mixes"
                / f"{w['traffic']}.json").is_file()
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))


def test_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in e2e
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert spec.metric_file(ROOT / "alora_bench", m["name"]).is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for w in M["workloads"]:
        cell = w["name"]
        mine = {n for n, m in e2e.items()
                if "workloads" not in m or cell in m["workloads"]}
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in M["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m
                     else m["moves"] in mine)]
        assert layer
        for m in layer:
            # a per-layer metric moves an end-to-end metric of the cell
            assert m["moves"] in mine, (cell, m["name"])
        # a kernel's roofline comes with the step's share of the peak,
        # moving the same metric
        for m in layer:
            if m["name"].split(".")[0].endswith("_roofline"):
                assert any("mfu" in x["name"] and x["moves"] == m["moves"]
                           for x in layer)
