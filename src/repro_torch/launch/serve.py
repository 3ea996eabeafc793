"""Serving launcher: run the paged serving engine with batched requests,
ported from the reference's ``repro/launch/serve.py``.

It builds a reduced model of the selected architecture, registers the
paper's vanilla-LoRA baseline adapters and then its aLoRA adapters,
replays a batch of base → adapter → base pipelines through an engine of
each, and prints per-stage latency and cache-hit metrics and the
paper's LoRA / aLoRA speedup table.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3.2-8b \\
      --requests 8 --prompt-len 128

It runs on the card; ``--device cpu`` runs every kernel's plain PyTorch
version instead.  ``--replicas N`` scales the same workload out over N
in-process engine replicas behind the cache-affinity router
(``serving/router.py``), all sharing one set of weights;
``--route {affinity,round_robin}`` selects the placement policy; with
``--replicas 1`` the engine is driven directly.

``--trace-out FILE`` exports the aLoRA run's trace rings (every
replica's, plus the router's, when a fleet ran) as a Perfetto timeline
(load it at https://ui.perfetto.dev); ``--metrics-out FILE`` writes the
same run's counters as a Prometheus text snapshot.

:func:`serve` is the launcher's body over a given ``ModelConfig``,
weights and adapters, so that a caller can drive it at full width.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.common import resolve_device
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.core.alora import (PAPER_ALORA_RANK, PAPER_LORA_RANK,
                                    AdapterSpec, Params,
                                    init_adapter_weights)
from repro_torch.models.model import init_params
from repro_torch.obs import prometheus_text, write_perfetto
from repro_torch.serving import (Engine, EngineConfig, fmt_speedups,
                                 speedup_table)
from repro_torch.serving import pipelines as P
from repro_torch.serving.pipelines import PipelineResult
from repro_torch.serving.router import POLICIES, Router

KINDS = ("lora", "alora")
Adapters = List[Tuple[AdapterSpec, Params]]


def adapter_specs(kind: str, n_adapters: int = 1) -> List[AdapterSpec]:
    """The launcher's adapters ``intrinsic0..``: the paper's rank-8
    vanilla LoRA for ``"lora"``, its rank-32 aLoRA with invocation
    tokens 3, 4, 5 for ``"alora"``."""
    if kind not in KINDS:
        raise ValueError(f"unknown adapter kind {kind!r}: expected one of "
                         f"{KINDS}")
    rank = PAPER_ALORA_RANK if kind == "alora" else PAPER_LORA_RANK
    inv = tuple(range(3, 6)) if kind == "alora" else None
    return [AdapterSpec(f"intrinsic{i}", rank=rank, invocation_tokens=inv)
            for i in range(n_adapters)]


def init_adapters(generator: torch.Generator, cfg: ModelConfig, kind: str,
                  n_adapters: int = 1, *, device="cuda") -> Adapters:
    """:func:`adapter_specs` with weights drawn from ``generator``."""
    return [(spec, init_adapter_weights(generator, cfg, spec.rank,
                                        device=device))
            for spec in adapter_specs(kind, n_adapters)]


def build_engine(cfg: ModelConfig, params, adapters: Adapters,
                 engine_cfg: EngineConfig = EngineConfig(),
                 replicas: int = 1, route: str = "affinity", *,
                 device="cuda"):
    """One engine, or — with ``replicas > 1`` — a Router over N
    identically built replicas (drop-in for the pipeline functions).
    Weights already on ``device`` are shared by every replica."""
    def mk() -> Engine:
        return Engine(cfg, params, adapters=adapters,
                      engine_cfg=engine_cfg, device=device)

    if replicas <= 1:
        return mk()
    return Router([mk() for _ in range(replicas)], policy=route)


def collect_tracers(eng):
    """Every tracer a serving tier carries: per-replica engine tracers
    plus the router's own when a fleet ran."""
    if isinstance(eng, Router):
        return [e.tracer for e in eng.replicas] + [eng.tracer]
    return [eng.tracer]


def serve(cfg: ModelConfig, params, adapters: Dict[str, Adapters], *,
          requests: int = 4, prompt_len: int = 128, gen_len: int = 32,
          eval_len: int = 16, replicas: int = 1, route: str = "affinity",
          trace_out: Optional[str] = None,
          metrics_out: Optional[str] = None, device="cuda"
          ) -> Dict[str, Tuple[object, PipelineResult]]:
    """The launcher's body: for each kind of ``adapters`` (``"lora"``,
    then ``"alora"``), a warm-up pass at seed 123 on a fresh engine, then
    the measured pass at seed 0 on another, each through
    ``pipelines.base_adapter`` with ``feed_back_to_base``; prints each
    stage's metrics and the eval stage's speedups and writes the aLoRA
    run's trace and counters where asked.  Returns kind → (the measured
    engine or router, its ``PipelineResult``)."""
    results = {}
    for kind in KINDS:
        # a warm-up pass, then a fresh engine measures with cold caches
        for seed in (123, 0):
            eng = build_engine(cfg, params, adapters[kind],
                               replicas=replicas, route=route, device=device)
            res = P.base_adapter(
                eng, adapter_names=[s.name for s, _ in adapters[kind]],
                prompt_len=prompt_len, gen_len=gen_len, eval_len=eval_len,
                batch=requests, feed_back_to_base=True, seed=seed)
        results[kind] = (eng, res)
        for stage in ("base", "eval", "final"):
            m = res.stage_metrics(eng, stage)
            print(f"  {kind:5s} {stage:5s} e2e={m.means['e2e']:.3f}s "
                  f"ttft={m.means['ttft']:.4f}s "
                  f"prefill={m.means['prefill']:.4f}s "
                  f"decode={m.means['decode']:.3f}s "
                  f"hit={m.means['cache_hit_frac']:.2f}", flush=True)
        if isinstance(eng, Router):
            per = [sum(1 for p in eng.placements if p.replica == i)
                   for i in range(len(eng.replicas))]
            print(f"  {kind:5s} fleet hit={eng.kv_hit_rate():.2f} "
                  f"placements/replica={per}", flush=True)

    sp = speedup_table(results["lora"][1].stage_metrics(
        results["lora"][0], "eval"),
        results["alora"][1].stage_metrics(results["alora"][0], "eval"))
    print("adapter-evaluation speedups (LoRA baseline / aLoRA):",
          fmt_speedups(sp), flush=True)

    if trace_out or metrics_out:
        trs = collect_tracers(results["alora"][0])
        if trace_out:
            write_perfetto(trace_out, trs)
            print(f"wrote Perfetto timeline -> {trace_out} "
                  "(load at https://ui.perfetto.dev)")
        if metrics_out:
            with open(metrics_out, "w") as f:
                f.write(prometheus_text(trs))
            print(f"wrote Prometheus counters -> {metrics_out}")
    return results


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3.2-8b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--eval-len", type=int, default=16)
    ap.add_argument("--adapters", type=int, default=1)
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the affinity router "
                         "(1 = no router tier)")
    ap.add_argument("--route", choices=POLICIES, default="affinity",
                    help="placement policy with --replicas > 1")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write the aLoRA run's Perfetto timeline JSON "
                         "here (load at https://ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="write the aLoRA run's counters here in the "
                         "Prometheus text exposition format")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu' (every kernel's "
                         "plain PyTorch version)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch)
    tier = f" x{args.replicas} replicas ({args.route})" \
        if args.replicas > 1 else ""
    print(f"serving reduced {cfg.name} ({cfg.arch_type}){tier} on {device}")
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(gen, cfg, device=device)
    adapters = {kind: init_adapters(gen, cfg, kind, args.adapters,
                                    device=device) for kind in KINDS}
    serve(cfg, params, adapters, requests=args.requests,
          prompt_len=args.prompt_len, gen_len=args.gen_len,
          eval_len=args.eval_len, replicas=args.replicas, route=args.route,
          trace_out=args.trace_out, metrics_out=args.metrics_out,
          device=device)


if __name__ == "__main__":
    main()
