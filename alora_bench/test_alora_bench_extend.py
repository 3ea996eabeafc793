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

from alora_bench import harness, reduced, spec

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
    for d in ("gen", "metrics", "families", "reference"):
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


# A family of its own: the stack's configuration, draw and FLOP count,
# judged by a reference written apart from ``reference/stack.py``.
FAMILY = '''"""The stack's model under a reference of its own."""
from pathlib import Path

from alora_bench import spec as S

STACK = S.load_module(Path(__file__).with_name("stack.py"))
REF = S.reference_module(Path(__file__))
config, dims_of, draw = STACK.config, STACK.dims_of, STACK.draw
step_flops = STACK.step_flops


def reference(dims, weights, layers, device, quant=None):
    return REF.Reference(dims, weights, layers, device, quant)
'''

REFERENCE = '''"""Attention+SwiGLU stacks, token by token through plain products."""
import torch
import torch.nn.functional as F

from alora_bench.reference.common import Plain

WITH_DELTA = {with_delta}


def norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rotate(x, theta):
    S, _, hd = x.shape
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32) / hd)
    ang = torch.arange(S, dtype=torch.float32)[:, None, None] * inv
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * ang.cos() - x2 * ang.sin(),
                      x1 * ang.sin() + x2 * ang.cos()], dim=-1)


class Reference(Plain):
    @torch.no_grad()
    def logits(self, seqs):
        d = self.dims
        f = lambda t: t.to(self.device, torch.float32)
        emb = f(self.w["embed"]["tok"])
        out = []
        for s in seqs:
            x = emb[torch.tensor(s.tokens)]
            S = x.shape[0]
            for li, lp in enumerate(self.w["layers"]):
                h = norm(x, f(lp["ln1"]), d["norm_eps"])
                qkv = []
                for n in "qkv":
                    y = h @ f(lp["attn"]["w" + n])
                    if WITH_DELTA and s.adapter is not None:
                        a, b = self.adapters[li][s.adapter][n]
                        y[s.inv_start:] += h[s.inv_start:] @ f(a) @ f(b)
                    qkv.append(y.reshape(S, -1, d["head_dim"]))
                q, k, v = qkv
                G = q.shape[1] // k.shape[1]
                q, k = rotate(q, d["rope_theta"]), rotate(k, d["rope_theta"])
                k, v = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
                sc = torch.einsum("qhd,khd->hqk", q, k) / d["head_dim"] ** 0.5
                sc = sc.masked_fill(torch.ones(S, S).triu(1).bool(),
                                    float("-inf"))
                o = torch.einsum("hqk,khd->qhd", sc.softmax(-1), v)
                x = x + o.reshape(S, -1) @ f(lp["attn"]["wo"])
                h = norm(x, f(lp["ln2"]), d["norm_eps"])
                m = lp["mlp"]
                x = x + (F.silu(h @ f(m["w_gate"])) * (h @ f(m["w_up"]))) \\
                    @ f(m["w_down"])
            h = norm(x[s.want], f(self.w["final_norm"]), d["norm_eps"])
            out.append(h @ emb.T)
        return out
'''


def bench_with_families(root: Path) -> Path:
    """A copy of the benchmark with two families added as files, each
    with a configuration (granite's, naming it) and a cell."""
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "alora_bench", root / "alora_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = root / "alora_bench"
    m = json.loads((root / "BENCHMARK.json").read_text())
    granite = json.loads((bench / "configs" / "granite-3.2-8b.json")
                         .read_text())
    for fam, with_delta in (("dense", True), ("dense_no_delta", False)):
        (bench / "families" / f"{fam}.py").write_text(FAMILY)
        (bench / "reference" / f"{fam}.py").write_text(
            REFERENCE.format(with_delta=with_delta))
        (bench / "configs" / f"granite-{fam}.json").write_text(
            json.dumps(dict(granite, family=fam)))
        (bench / "cells" / f"granite-{fam}.json").write_text(json.dumps(
            {"rate": 8.0, "limits": {"max_logit_gap": 1e-4}}))
        m["configs"].append({"name": f"granite-{fam}",
                             "source": "test size only",
                             "file": f"alora_bench/configs/granite-{fam}.json",
                             "reduced": [], "why": "a family from files"})
        m["workloads"].append({"name": f"granite-{fam}",
                               "config": f"granite-{fam}",
                               "traffic": "rag-alora-sessions", "chips": 1,
                               "why": "a family from files"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


# the reduced granite at a width where attention, not the token's own
# tied embedding, decides the logits, with adapters whose deltas move
# them on every seed, and longer evaluations
WIDE = spec.deep_merge(reduced.OVERRIDES, {
    "config": {"reduced_model": {"d_model": 1024, "num_heads": 8,
                                 "num_kv_heads": 2, "head_dim": 128,
                                 "d_ff": 2048},
               "adapters": {"b_std": 0.5}},
    "mix": {"eval_output": [6, 10]}})


@pytest.mark.parametrize("family,correct", [("dense", True),
                                            ("dense_no_delta", False)])
def test_a_family_from_files(family, correct, tmp_path):
    """The harness runs a cell of a family added as files and judges it
    by that family's reference: its own reference passes the served
    tokens, and one that leaves out the adapter's delta fails them."""
    root = bench_with_families(tmp_path)
    result, _ = harness.run(f"granite-{family}", 24680, 1.5, False,
                            device="cpu", root=root, overrides=WIDE,
                            reduced=True)
    assert result["readings"]["adapted"] >= 1
    assert result["correct"] is correct, result["readings"]


def test_an_unknown_family_fails_before_any_traffic():
    ov = {"config": {"family": "no_such_family"}}
    with pytest.raises(ValueError, match="no_such_family"):
        spec.load("granite-rag-alora", ROOT, ov)
    with pytest.raises(ValueError, match="no_such_family"):
        harness.run("granite-rag-alora", 1, 1.0, False, device="cpu",
                    overrides=spec.deep_merge(reduced.OVERRIDES, ov),
                    reduced=True)
