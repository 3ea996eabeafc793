"""Shared benchmark scaffolding, the reference's
``benchmarks/common.py`` on the port.

Every benchmark mirrors one paper table or figure.  By default the
model is the reduced 2-layer granite-3.2-8b (the paper's own base model
family) with random weights from a seed, as in the reference;
:func:`install` serves an architecture from the caller's model instead
(full-width weights on the card, or weights converted from the
reference).  LoRA-vs-aLoRA comparisons run both variants over identical
pipelines after a warm-up round (another seed).

On the card every mixed step launches the serving kernels a fixed
number of times (B1 and B2's fused Q/K/V entry once per attention
layer, B2's one-pair entry and B3 once per SSM layer): the port's
counterpart of the reference's one device call per step, read from the
wrappers' ``launches`` counters (``kernels.launch_counts``,
:func:`step_launches`).  The reference's ``recompiles == 0`` asserts
return with the captured step (ROADMAP A8).

Artifacts go to ``results/torch/`` under the reference's file names.
"""
from __future__ import annotations

import os
import sys
from typing import Callable, Dict, Optional

import torch

from repro_torch.common import tree_leaves
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.core.alora import (PAPER_ALORA_RANK, PAPER_LORA_RANK,
                                    AdapterSpec, Params,
                                    init_adapter_weights)
from repro_torch.kernels import launch_counts
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import init_params
from repro_torch.serving import Engine, EngineConfig

SEED = 0
INV = (7, 8, 9)
ARCH = "granite-3.2-8b"
RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "..", "results", "torch")

# (arch, device type) → (cfg, params, adapter_weights(rank, i) or None)
_models: Dict = {}
# default adapter weights, drawn once: (arch, device type, rank, i)
_adapters: Dict = {}


def install(arch: str, cfg: ModelConfig, params: Params,
            adapter_weights: Callable[[int, int], Params]) -> None:
    """Serve ``arch`` from the caller's model on the device its weights
    live on: ``adapter_weights(rank, i)`` returns adapter ``i``'s weights
    at ``rank`` (called at every registration)."""
    dev = tree_leaves(params)[0].device.type
    _models[(arch, dev)] = (cfg, params, adapter_weights)


def uninstall() -> None:
    """Forget every installed and drawn model."""
    _models.clear()
    _adapters.clear()


def model(arch: str = ARCH, device="cuda"):
    """(cfg, params) of ``arch`` on ``device``: the installed model, else
    the reduced config with random weights from ``SEED``."""
    dev = torch.device(device).type
    if (arch, dev) not in _models:
        cfg = get_reduced(arch)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        _models[(arch, dev)] = (cfg, init_params(gen, cfg, device=dev), None)
    cfg, params, _ = _models[(arch, dev)]
    return cfg, params


def adapter_weights(arch: str, rank: int, i: int, device="cuda") -> Params:
    dev = torch.device(device).type
    cfg, _ = model(arch, dev)
    fn = _models[(arch, dev)][2]
    if fn is not None:
        return fn(rank, i)
    key = (arch, dev, rank, i)
    if key not in _adapters:
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        _adapters[key] = init_adapter_weights(gen, cfg, rank, device=dev)
    return _adapters[key]


def make_engine(kind: str, n_adapters: int = 1,
                ecfg: Optional[EngineConfig] = None, arch: str = ARCH,
                device="cuda") -> Engine:
    """An engine with ``n_adapters`` adapters ``ad0..``: rank-32 aLoRA
    with invocation tokens ``INV`` shifted by ``i`` for ``"alora"``, the
    paper's rank-8 vanilla LoRA for ``"lora"``."""
    cfg, params = model(arch, device)
    rank = PAPER_ALORA_RANK if kind == "alora" else PAPER_LORA_RANK
    ads = []
    for i in range(n_adapters):
        inv = tuple(x + i for x in INV) if kind == "alora" else None
        spec = AdapterSpec(f"ad{i}", rank=rank, invocation_tokens=inv)
        ads.append((spec, adapter_weights(arch, rank, i, device)))
    return Engine(cfg, params, adapters=ads,
                  engine_cfg=ecfg or EngineConfig(), device=device)


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    """CSV contract: name,us_per_call,derived."""
    print(f"{name},{us_per_call:.1f},{derived}")
    sys.stdout.flush()


def stage_row(metrics) -> str:
    """Render stage means; an EMPTY aggregate (a pipeline stage that saw
    no requests) yields NaNs from ``MetricsAggregate.row`` and renders
    every field as ``-`` instead of raising KeyError."""
    m = metrics.row(("queue", "prefill", "decode", "ttft",
                     "cache_hit_frac"))

    def us(v):
        return "-" if v != v else f"{v * 1e6:.0f}us"

    hit = "-" if m["cache_hit_frac"] != m["cache_hit_frac"] \
        else f"{m['cache_hit_frac']:.2f}"
    return (f"queue={us(m['queue'])} prefill={us(m['prefill'])} "
            f"decode={us(m['decode'])} ttft={us(m['ttft'])} hit={hit}")


def exact(eng) -> bool:
    """Token identity is asserted on float32 models; a bf16 model's
    random-weight logits tie, so there the agreement is printed."""
    return dtype_of(eng.cfg) == torch.float32


def agreement(a, b) -> str:
    same = sum(x == y for p, q in zip(a, b) for x, y in zip(p, q))
    return f"{same}/{sum(len(p) for p in a)} tokens agree"


def results_path(name: str) -> str:
    os.makedirs(RESULTS, exist_ok=True)
    return os.path.join(RESULTS, name)


def step_launches(eng, steps: int, before: Dict[str, int]
                  ) -> Dict[str, float]:
    """The serving kernels' launches per mixed step since ``before``.  On
    the card each must be its per-layer count (B1 and the fused B2 once
    per attention layer, the one-pair B2 and B3 once per SSM layer;
    asserted); on the CPU the wrappers launch nothing and count 0."""
    got = {k: v - before[k] for k, v in launch_counts().items()}
    if eng.runner.device.type == "cuda":
        La, Ls = eng.runner.La, eng.runner.Ls
        want = {"ragged_paged_attention": La,
                "ragged_grouped_lora_qkv": La if eng.adapter_pool else 0,
                "ragged_grouped_lora": Ls if eng.adapter_pool else 0,
                "ragged_ssd_chunk_scan": Ls}
        assert got == {k: n * steps for k, n in want.items()}, \
            (got, want, steps)
    return {k: v / max(steps, 1) for k, v in got.items()}


def fmt_launches(per_step: Dict[str, float]) -> str:
    return " ".join(f"{k}={v:g}" for k, v in per_step.items() if v)


class Rows(dict):
    """A bench's CSV rows by name, each with the numbers it was built
    from (what the tests compare with the reference's)."""

    def add(self, name: str, us_per_call: float, derived: str = "",
            **data) -> None:
        emit(name, us_per_call, derived)
        self[name] = dict(us=us_per_call, derived=derived, **data)


def stage_data(eng, ids) -> dict:
    """Per-request tokens and reused prompt tokens of ``ids``."""
    return dict(tokens=[list(eng.request(i).output_tokens) for i in ids],
                hits=[eng.request(i).n_cache_hit_tokens for i in ids])


def bench_args(description: str, argv=None, **extra):
    """The common command line of a bench module: ``--device`` (default:
    the card), ``--smoke``, ``--arch`` and the bench's own flags
    (``extra``: flag → argparse keywords)."""
    import argparse
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny workload (the CI smoke leg)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu' (every kernel's "
                         "plain PyTorch version)")
    for flag, kw in extra.items():
        ap.add_argument(flag, **kw)
    return ap.parse_args(argv)
