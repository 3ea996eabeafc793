"""Paper Fig. 15 (App. F): batch-size effect — larger concurrent batches
shift E2E toward decode time, motivating the paper's fixed-batch-size
methodology for the prompt-length sweeps; the reference's
``benchmarks/bench_batch_size.py`` on the port.  ``--smoke`` runs the
first batch size only."""
from __future__ import annotations

from repro_torch.benchmarks.common import (ARCH, Rows, bench_args,
                                           make_engine, stage_data,
                                           stage_row)
from repro_torch.common import resolve_device
from repro_torch.serving import EngineConfig
from repro_torch.serving import pipelines as P

BATCHES = [1, 2, 4]


def run(arch: str = ARCH, smoke: bool = False, device="cuda",
        batches=None) -> Rows:
    device = resolve_device(device)
    rows = Rows()
    for b in batches or (BATCHES[:1] if smoke else BATCHES):
        for seed in (999, b):                     # warmup + measured
            eng = make_engine("alora", ecfg=EngineConfig(max_running=8),
                              arch=arch, device=device)
            res = P.base_adapter(eng, adapter_names=["ad0"],
                                 prompt_len=48, gen_len=24, eval_len=8,
                                 batch=b, seed=seed)
        m = res.stage_metrics(eng, "eval")
        rows.add(f"fig15/eval/batch{b}", m.means["e2e"] * 1e6, stage_row(m),
                 hit=m.means["cache_hit_frac"],
                 **stage_data(eng, res.base_ids + res.eval_ids))
    return rows


if __name__ == "__main__":
    a = bench_args(__doc__.splitlines()[0])
    run(a.arch, a.smoke, a.device)
