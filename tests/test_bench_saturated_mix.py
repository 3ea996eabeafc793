"""The saturated RAG cell's mix is ``rag-alora-sessions`` under a name of
its own: the same generator and parameters, so a seed gives the same
sessions at the same offsets as in the cell below the knee."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from alora_bench import spec

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "alora_bench"
INV = [(100 - 3 * a - 1, 100 - 3 * a - 2, 100 - 3 * a - 3) for a in range(8)]


def mix(name):
    return json.loads((BENCH / "mixes" / f"{name}.json").read_text())


def test_saturated_cell_runs_the_sessions_mix():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    sat, below = cells["granite-rag-saturated"], cells["granite-rag-alora"]
    assert sat["config"] == below["config"]
    a, b = mix(sat["traffic"]), mix(below["traffic"])
    a.pop("why"), b.pop("why")
    assert a == b


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11, 2 ** 40 + 7])
def test_saturated_mix_draws_the_same_sessions(seed):
    make = spec.load_module(BENCH / "gen" / "sessions.py").make
    streams = [make(mix(name), seed=seed, rate=3.4, vocab=(1, 49000),
                    invocations=INV)
               for name in ("rag-alora-saturated", "rag-alora-sessions")]
    for _ in range(64):
        (ta, sa), (tb, sb) = (next(g) for g in streams)
        assert ta == tb
        assert (sa.first().prompt, sa.first().max_new, sa.adapter,
                sa.eval_out, sa.final) == (sb.first().prompt,
                                           sb.first().max_new, sb.adapter,
                                           sb.eval_out, sb.final)
