"""Paper Fig. 8/9 (+13/14): asynchronous Poisson-arrival base→adapter
pipeline, varying arrival rate; the reference's
``benchmarks/bench_async.py`` on the port.

Reproduces the qualitative claims: higher arrival rates yield larger
aLoRA speedups (queue-time savings from the missing prefill backlog)
until cache capacity is reached, after which reuse decays (Fig. 9: a
24-block pool evicts the base blocks before their adapter call
arrives).  ``--smoke`` runs the first arrival rate, then the capacity
cliff.  ``time_scale`` is ``EngineConfig.time_scale`` (0: the virtual
clock moves only to arrivals, a schedule independent of the host).
"""
from __future__ import annotations

from repro_torch.benchmarks.common import (ARCH, Rows, bench_args,
                                           make_engine, stage_data,
                                           stage_row)
from repro_torch.common import resolve_device
from repro_torch.serving import EngineConfig
from repro_torch.serving import pipelines as P
from repro_torch.serving.metrics import fmt_speedups, speedup_table

RATES = [1.0, 4.0, 16.0]
N_REQ = 6
CAPACITY = ((512, "ample"), (24, "tight"))


def run(arch: str = ARCH, smoke: bool = False, device="cuda", rates=None,
        time_scale: float = 1.0) -> Rows:
    device = resolve_device(device)
    rows = Rows()
    for rate in rates or (RATES[:1] if smoke else RATES):
        stages = {}
        for kind in ("lora", "alora"):
            for seed in (999, int(rate * 10)):    # warmup + measured
                eng = make_engine(kind, arch=arch, device=device,
                                  ecfg=EngineConfig(time_scale=time_scale))
                res = P.async_base_adapter(
                    eng, adapter_name="ad0", arrival_rate=rate,
                    num_requests=N_REQ, prompt_len=64, gen_len=24,
                    eval_len=8, seed=seed)
            m = res.stage_metrics(eng, "eval")
            stages[kind] = m
            rows.add(f"fig8/eval/{kind}/rate{rate}", m.means["e2e"] * 1e6,
                     stage_row(m), hit=m.means["cache_hit_frac"],
                     **stage_data(eng, res.eval_ids))
            # wall-clock throughput over the stage's makespan (max done −
            # min arrival) — NOT tokens/Σe2e, which double-counts
            # overlapped request lifetimes under concurrency; the
            # per-request service rate is reported alongside
            rows.add(f"fig8/throughput/{kind}/rate{rate}",
                     m.throughput_tok_per_s,
                     f"tok/s over makespan; per-request rate="
                     f"{m.tok_per_req_s:.1f} tok/s")
        sp = speedup_table(stages["lora"], stages["alora"])
        rows.add(f"fig8/speedup/rate{rate}", 0.0, fmt_speedups(sp))

    # Fig. 9: cache-capacity cliff — a pool smaller than the in-flight
    # working set evicts base blocks before their adapter call arrives,
    # destroying reuse (and queue times blow up from block starvation)
    for blocks, label in CAPACITY:
        for seed in (99, 7):                      # warmup + measured
            eng = make_engine("alora", arch=arch, device=device,
                              ecfg=EngineConfig(num_blocks=blocks,
                                                time_scale=time_scale))
            res = P.async_base_adapter(eng, adapter_name="ad0",
                                       arrival_rate=32.0,
                                       num_requests=8, prompt_len=96,
                                       gen_len=24, eval_len=8, seed=seed)
        m = res.stage_metrics(eng, "eval")
        rows.add(f"fig9/capacity-{label}/blocks{blocks}",
                 m.means["e2e"] * 1e6,
                 f"hit={m.means['cache_hit_frac']:.2f} "
                 f"evictions={eng.kv_mgr.evictions}",
                 hit=m.means["cache_hit_frac"],
                 evictions=eng.kv_mgr.evictions,
                 **stage_data(eng, res.eval_ids))
    return rows


if __name__ == "__main__":
    a = bench_args(__doc__.splitlines()[0])
    run(a.arch, a.smoke, a.device)
