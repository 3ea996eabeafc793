"""Asynchronous serving under Poisson arrivals (paper §4.3), the
reference's ``examples/async_poisson.py`` on the port.

Pipeline instances arrive at rate λ; each runs base→adapter with the
adapter request submitted the instant its base request completes.  The
engine's virtual clock + measured step times reproduce queue-buildup
dynamics: watch LoRA queue times blow up at high λ while aLoRA stays
flat (no prefill backlog).

  PYTHONPATH=src python -m repro_torch.examples.async_poisson --rate 8 \\
      [--device cpu]

``main(model=(cfg, params, adapter_weights))`` runs it on the caller's
model instead (``adapter_weights(rank)`` draws one adapter).
"""
import argparse
import sys

import torch

from repro_torch.common import resolve_device
from repro_torch.configs import get_reduced
from repro_torch.core.alora import AdapterSpec, init_adapter_weights
from repro_torch.models.model import init_params
from repro_torch.serving import Engine
from repro_torch.serving import pipelines as P

INV = (7, 8, 9)


def main(device=None, argv=(), model=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rate", type=float, default=8.0)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(device or args.device)

    if model is None:
        cfg = get_reduced("granite-3.2-8b")
        params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             device=dev)

        def adapter_weights(rank):
            g = torch.Generator(device=dev).manual_seed(1)
            return init_adapter_weights(g, cfg, rank, device=dev)
    else:
        cfg, params, adapter_weights = model

    out = {}
    for kind in ("lora", "alora"):
        rank = 32 if kind == "alora" else 8
        spec = AdapterSpec("judge", rank=rank,
                           invocation_tokens=INV if kind == "alora"
                           else None)
        w = adapter_weights(rank)
        for seed in (99, 0):
            eng = Engine(cfg, params, adapters=[(spec, w)], device=dev)
            res = P.async_base_adapter(
                eng, adapter_name="judge", arrival_rate=args.rate,
                num_requests=args.requests, prompt_len=64, gen_len=24,
                eval_len=8, seed=seed)
        m = res.stage_metrics(eng, "eval")
        out[kind] = (eng, res)
        print(f"{kind:5s} λ={args.rate}: eval "
              f"queue={m.means['queue']*1e3:.1f}ms "
              f"prefill={m.means['prefill']*1e3:.1f}ms "
              f"e2e={m.means['e2e']*1e3:.1f}ms "
              f"hit={m.means['cache_hit_frac']:.0%} "
              f"(p99 e2e={m.p99['e2e']*1e3:.1f}ms)")
    return out


if __name__ == "__main__":
    main(argv=sys.argv[1:])
