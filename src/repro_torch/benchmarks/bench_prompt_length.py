"""Paper Fig. 6 + Fig. 12: base → adapter pipeline, varying prompt
length; the reference's ``benchmarks/bench_prompt_length.py`` on the
port.

Evaluation-step stage latencies (queue/prefill/decode, TTFT, E2E) for
vanilla LoRA (rank 8) against aLoRA (rank 32), plus the prefix-cache
hit rate (§4.2 reports 84% at prompt 1024; the hit rate here is tokens
reused / prompt length of the adapter call).  ``--smoke`` runs the first
prompt length only.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import (ARCH, Rows, bench_args,
                                           make_engine, stage_data,
                                           stage_row)
from repro_torch.common import resolve_device
from repro_torch.serving import pipelines as P
from repro_torch.serving.metrics import fmt_speedups, speedup_table

PROMPT_LENS = [48, 96, 192, 384]
GEN_LEN = 32
EVAL_LEN = 8


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
                res = P.base_adapter(eng, adapter_names=["ad0"],
                                     prompt_len=plen, gen_len=GEN_LEN,
                                     eval_len=EVAL_LEN, batch=2, seed=seed)
            m = res.stage_metrics(eng, "eval")
            stage[kind] = m
            rows.add(f"fig6/eval/{kind}/prompt{plen}",
                     m.means["e2e"] * 1e6, stage_row(m),
                     hit=m.means["cache_hit_frac"],
                     **stage_data(eng, res.eval_ids))
        sp = speedup_table(stage["lora"], stage["alora"])
        rows.add(f"fig6/speedup/prompt{plen}", 0.0, fmt_speedups(sp))
    return rows


if __name__ == "__main__":
    a = bench_args(__doc__.splitlines()[0])
    run(a.arch, a.smoke, a.device)
