"""Quickstart: cross-model KV-cache reuse with Activated LoRA, the
reference's ``examples/quickstart.py`` on the port.

Builds a reduced Granite-family model, registers one aLoRA "intrinsic"
(e.g. an uncertainty-quantification head), runs the paper's atomic
pipeline — base answers, adapter evaluates the answer — and shows the
adapter's prefill reusing the base model's cache blocks.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

``main(model=(cfg, params, adapter_weights))`` runs it on the caller's
model instead (``adapter_weights(rank)`` draws one adapter).
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.configs import get_reduced
from repro_torch.core.alora import AdapterSpec, init_adapter_weights
from repro_torch.models.model import init_params
from repro_torch.serving import Engine

INV = (7, 8, 9)                      # the "<|uq|>" activation sequence


def main(device=None, argv=(), model=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(device or ap.parse_args(argv).device)

    # 1. model + engine -------------------------------------------------
    if model is None:
        cfg = get_reduced("granite-3.2-8b")
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(gen, cfg, device=dev)

        def adapter_weights(rank):
            g = torch.Generator(device=dev).manual_seed(1)
            return init_adapter_weights(g, cfg, rank, device=dev)
    else:
        cfg, params, adapter_weights = model

    # 2. one Activated-LoRA adapter: identified by its invocation tokens
    adapter = AdapterSpec("uq", rank=32, invocation_tokens=INV)
    engine = Engine(cfg, params, adapters=[(adapter, adapter_weights(32))],
                    device=dev)

    # 3. turn 1 — the BASE model answers a prompt -----------------------
    prompt = list(np.random.RandomState(0).randint(10, cfg.vocab_size, 120))
    rid = engine.submit(prompt, max_new_tokens=24)
    engine.run_until_idle()
    answer = engine.request(rid).output_tokens
    print(f"base answered {len(answer)} tokens")

    # 4. turn 2 — the aLoRA adapter EVALUATES (prompt + answer) ---------
    #    its prefill transparently reuses the base model's KV blocks:
    #    only tokens from the last un-cached block onward are recomputed.
    eval_prompt = prompt + answer + list(INV)
    rid2 = engine.submit(eval_prompt, max_new_tokens=8, adapter_name="uq")
    engine.run_until_idle()
    req = engine.request(rid2)
    m = req.metrics()
    print(f"adapter evaluation: {req.output_tokens}")
    print(f"  cache reuse: {req.n_cache_hit_tokens}/{len(eval_prompt)} "
          f"tokens ({m['cache_hit_frac']:.0%})  — vanilla LoRA would "
          "reuse 0")
    print(f"  TTFT {m['ttft']*1e3:.1f} ms   prefill {m['prefill']*1e3:.1f} "
          f"ms   E2E {m['e2e']*1e3:.1f} ms")
    assert req.n_cache_hit_tokens > 0
    return req


if __name__ == "__main__":
    main(argv=sys.argv[1:])
