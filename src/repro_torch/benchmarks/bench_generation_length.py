"""Paper Fig. 10: base→adapter→base, varying the FIRST base call's
generation length; the reference's
``benchmarks/bench_generation_length.py`` on the port.

Prefix caching doesn't distinguish prefilled from generated blocks
(§4.4), so speedups track total context length; queueing delays from
LoRA prefills hit the second base call's TTFT.  ``--smoke`` runs the
first generation length only.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import (ARCH, Rows, bench_args,
                                           make_engine, stage_data,
                                           stage_row)
from repro_torch.common import resolve_device
from repro_torch.serving import pipelines as P
from repro_torch.serving.metrics import fmt_speedups, speedup_table

GEN_LENS = [16, 48, 96, 192]


def run(arch: str = ARCH, smoke: bool = False, device="cuda",
        gen_lens=None) -> Rows:
    device = resolve_device(device)
    rows = Rows()
    for glen in gen_lens or (GEN_LENS[:1] if smoke else GEN_LENS):
        stages = {}
        for kind in ("lora", "alora"):
            for seed in (9990 + glen, glen):      # warmup + measured
                eng = make_engine(kind, arch=arch, device=device)
                res = P.base_adapter(eng, adapter_names=["ad0"],
                                     prompt_len=48, gen_len=glen,
                                     eval_len=8, batch=2,
                                     feed_back_to_base=True, seed=seed)
            m_eval = res.stage_metrics(eng, "eval")
            m_final = res.stage_metrics(eng, "final")
            stages[kind] = m_eval
            rows.add(f"fig10/eval/{kind}/gen{glen}",
                     m_eval.means["e2e"] * 1e6, stage_row(m_eval),
                     hit=m_eval.means["cache_hit_frac"],
                     **stage_data(eng, res.eval_ids))
            rows.add(f"fig10/final-base/{kind}/gen{glen}",
                     m_final.means["e2e"] * 1e6,
                     f"ttft={m_final.means['ttft']*1e6:.0f}us "
                     f"hit={m_final.means['cache_hit_frac']:.2f}",
                     hit=m_final.means["cache_hit_frac"],
                     **stage_data(eng, res.final_ids))
        sp = speedup_table(stages["lora"], stages["alora"])
        rows.add(f"fig10/speedup-eval/gen{glen}", 0.0, fmt_speedups(sp))
    return rows


if __name__ == "__main__":
    a = bench_args(__doc__.splitlines()[0])
    run(a.arch, a.smoke, a.device)
