"""End-to-end serving example: batched multi-turn, multi-adapter traffic
through the full engine (continuous batching + chunked prefill + paged
KV cache + cross-model reuse), LoRA baseline vs aLoRA; the reference's
``examples/serve_multiturn.py`` on the port.

This is the paper's base→adapter→base pipeline (Fig. 4) over a batch of
concurrent conversations, reporting per-stage latencies per Table 2.

  PYTHONPATH=src python -m repro_torch.examples.serve_multiturn \\
      [--arch granite-3.2-8b] [--device cpu]

``main(model=(cfg, params, adapter_weights))`` runs it on the caller's
model instead (``adapter_weights(rank)`` draws one adapter).
"""
import argparse
import sys

import torch

from repro_torch.common import resolve_device
from repro_torch.configs import get_reduced, list_archs
from repro_torch.core.alora import AdapterSpec, init_adapter_weights
from repro_torch.models.model import init_params
from repro_torch.serving import Engine, fmt_speedups, speedup_table
from repro_torch.serving import pipelines as P

INV = (7, 8, 9)


def main(device=None, argv=(), model=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3.2-8b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(device or args.device)

    if model is None:
        cfg = get_reduced(args.arch)
        params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             device=dev)

        def adapter_weights(rank):
            g = torch.Generator(device=dev).manual_seed(1)
            return init_adapter_weights(g, cfg, rank, device=dev)
    else:
        cfg, params, adapter_weights = model
    print(f"== serving {cfg.name} ({cfg.arch_type}), "
          f"{args.batch} concurrent conversations on {dev} ==")
    w8, w32 = adapter_weights(8), adapter_weights(32)

    results = {}
    for kind, rank, w in (("lora", 8, w8), ("alora", 32, w32)):
        inv = INV if kind == "alora" else None
        spec = AdapterSpec("judge", rank=rank, invocation_tokens=inv)
        for seed in (99, 0):                      # warmup + measured
            eng = Engine(cfg, params, adapters=[(spec, w)], device=dev)
            res = P.base_adapter(
                eng, adapter_names=["judge"], prompt_len=args.prompt_len,
                gen_len=32, eval_len=8, batch=args.batch,
                feed_back_to_base=True, seed=seed)
        results[kind] = (eng, res)
        for stage in ("base", "eval", "final"):
            m = res.stage_metrics(eng, stage)
            print(f"  {kind:5s} {stage:5s}: e2e={m.means['e2e']*1e3:7.1f}ms"
                  f"  ttft={m.means['ttft']*1e3:7.1f}ms"
                  f"  prefill={m.means['prefill']*1e3:7.1f}ms"
                  f"  decode={m.means['decode']*1e3:7.1f}ms"
                  f"  hit={m.means['cache_hit_frac']:.0%}")
    sp = speedup_table(results["lora"][1].stage_metrics(
        results["lora"][0], "eval"),
        results["alora"][1].stage_metrics(results["alora"][0], "eval"))
    print("== adapter-evaluation speedup (aLoRA over LoRA baseline) ==")
    print("   " + fmt_speedups(sp))
    return results


if __name__ == "__main__":
    main(argv=sys.argv[1:])
