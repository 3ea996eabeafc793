"""Paper Fig. 11 (App. C): adapter→base pipeline — two-way reuse; the
reference's ``benchmarks/bench_adapter_base.py`` on the port.

The adapter screens the prompt first; the base model then generates and
reuses the adapter's pre-activation prefill blocks.  ``--smoke`` runs
the first prompt length only.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import (ARCH, Rows, bench_args,
                                           make_engine, stage_data,
                                           stage_row)
from repro_torch.common import resolve_device
from repro_torch.serving import pipelines as P
from repro_torch.serving.metrics import fmt_speedups, speedup_table

PROMPT_LENS = [48, 96, 192]


def run(arch: str = ARCH, smoke: bool = False, device="cuda",
        prompt_lens=None) -> Rows:
    device = resolve_device(device)
    lens = prompt_lens or (PROMPT_LENS[:1] if smoke else PROMPT_LENS)
    rows = Rows()
    for plen in lens:
        stage = {}
        for kind in ("lora", "alora"):
            for seed in (9990 + plen, plen):      # warmup + measured
                eng = make_engine(kind, arch=arch, device=device)
                res = P.adapter_base(eng, adapter_name="ad0",
                                     prompt_len=plen, eval_len=16,
                                     gen_len=16, batch=2, seed=seed)
            m = res.stage_metrics(eng, "final")   # the base call
            stage[kind] = m
            rows.add(f"fig11/base-after-adapter/{kind}/prompt{plen}",
                     m.means["e2e"] * 1e6, stage_row(m),
                     hit=m.means["cache_hit_frac"],
                     **stage_data(eng, res.eval_ids + res.final_ids))
        sp = speedup_table(stage["lora"], stage["alora"])
        rows.add(f"fig11/speedup/prompt{plen}", 0.0, fmt_speedups(sp))
    return rows


if __name__ == "__main__":
    a = bench_args(__doc__.splitlines()[0])
    run(a.arch, a.smoke, a.device)
