"""Paper §4.4.1: five adapters invoked in parallel on the same (x+y)
context + consolidated final base call; the reference's
``benchmarks/bench_multi_adapter.py`` on the port.

``--churn`` instead exercises the dynamic adapter lifecycle: more
adapters REGISTERED than device slots, requests cycling through them so
admission constantly pins/evicts/prefetches slots.  Asserts the churn
invariants:

* one mixed step per work step (``runner.call_counts["mixed_step"]``),
  and on the card the serving kernels' launches per step — adapter
  installs and prefetches happen off the step path;
* output token-identical to an all-resident sequential oracle (asserted
  on the reduced float32 model; at full width in bf16, where the random
  model's logits tie, the agreement is printed instead);
* evictions > 0.

The reference's ``recompiles == 0`` assert waits for the captured step
(ROADMAP A8).  Adapter-lifecycle counters (prefetch issued/hit,
evictions, occupancy, stalled installs) are emitted per run and appended
to ``results/torch/adapter_pool.jsonl``.

``--zipf`` is the thousand-adapter scheduling leg: a deep queue of
requests whose adapters follow a Zipf popularity law over far more
registrations than device slots, run twice on the SAME trace — under
the strict-FCFS admission oracle and under the adapter-affinity
scheduler (the default).  Asserts the affinity scheduler's measured win
(strictly fewer acquire-fails and stalled installs, strictly lower mean
queue wait in steps, no staging copy left), token identity between the
two policies on an uncontended-slot trace (reduced float32), and one
mixed step per work step under reordering.  Appends per-policy rows to
``results/torch/adapter_sched.jsonl``.  ``n_adapters`` / ``n_requests``
cut the registrations and the trace (a full-width granite adapter of
rank 32 holds ~47 MB of pinned host memory).
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.benchmarks.common import (ARCH, Rows, agreement,
                                           bench_args, exact, fmt_launches,
                                           launch_counts, make_engine,
                                           results_path, stage_data,
                                           stage_row, step_launches)
from repro_torch.common import resolve_device
from repro_torch.serving import EngineConfig
from repro_torch.serving import pipelines as P
from repro_torch.serving.metrics import fmt_speedups, speedup_table

N_ADAPTERS = 5


def run(arch: str = ARCH, device="cuda") -> Rows:
    device = resolve_device(device)
    names = [f"ad{i}" for i in range(N_ADAPTERS)]
    rows = Rows()
    stages = {}
    for kind in ("lora", "alora"):
        for seed in (999, 4):                     # warmup + measured
            eng = make_engine(kind, n_adapters=N_ADAPTERS, arch=arch,
                              device=device)
            res = P.base_adapter(eng, adapter_names=names, prompt_len=64,
                                 gen_len=32, eval_len=8,
                                 feed_back_to_base=True, seed=seed)
        m_eval = res.stage_metrics(eng, "eval")
        m_final = res.stage_metrics(eng, "final")
        stages[kind] = m_eval
        rows.add(f"sec441/eval-5adapters/{kind}", m_eval.means["e2e"] * 1e6,
                 stage_row(m_eval), hit=m_eval.means["cache_hit_frac"],
                 **stage_data(eng, res.eval_ids))
        rows.add(f"sec441/final-base/{kind}", m_final.means["e2e"] * 1e6,
                 f"ttft={m_final.means['ttft']*1e6:.0f}us "
                 f"hit={m_final.means['cache_hit_frac']:.2f}",
                 hit=m_final.means["cache_hit_frac"],
                 **stage_data(eng, res.final_ids))
    sp = speedup_table(stages["lora"], stages["alora"])
    rows.add("sec441/speedup-eval", 0.0, fmt_speedups(sp))
    return rows


# ---------------------------------------------------------------------------
# adapter-churn leg (dynamic adapter lifecycle)
# ---------------------------------------------------------------------------
def _churn_workload(eng, *, n_adapters: int, reps: int, prompt_len: int,
                    gen_len: int, seed: int):
    rng = np.random.RandomState(seed)
    rids = []
    k = 0
    for rep in range(reps):
        for i in range(n_adapters):
            inv = list(eng.adapters[f"ad{i}"].spec.invocation_tokens)
            prompt = list(rng.randint(10, 400, prompt_len)) + inv
            rids.append(eng.submit(prompt, gen_len,
                                   adapter_name=f"ad{i}",
                                   arrival_time=1e-9 * k))
            k += 1
    steps, times, occ = 0, [], []
    while eng.pending or eng.waiting or eng.running:
        dt = eng.step()
        n_d, n_p = eng.last_step_tokens
        if n_d or n_p:
            steps += 1
            times.append(dt)
            occ.append(eng.adapter_pool.occupancy)
    return rids, steps, times, occ


def run_churn(arch: str = ARCH, smoke: bool = False, device="cuda") -> Rows:
    device = resolve_device(device)
    n_adapters = 4 if smoke else 8
    slots = 2 if smoke else 3
    prompt_len = 24 if smoke else 64
    gen_len = 6 if smoke else 16
    reps = 2 if smoke else 3
    kw = dict(n_adapters=n_adapters, reps=reps, prompt_len=prompt_len,
              gen_len=gen_len)

    # all-resident sequential oracle for token-identity
    eng_o = make_engine("alora", n_adapters=n_adapters, arch=arch,
                        device=device,
                        ecfg=EngineConfig(max_running=4,
                                          execution_mode="sequential"))
    rids_o, *_ = _churn_workload(eng_o, seed=7, **kw)
    oracle = [eng_o.request(r).output_tokens for r in rids_o]
    del eng_o

    def mk():
        return make_engine("alora", n_adapters=n_adapters, arch=arch,
                           device=device,
                           ecfg=EngineConfig(max_running=4,
                                             adapter_slots=slots))

    _churn_workload(mk(), seed=999, **kw)         # warmup
    eng = mk()                                    # fresh pool
    before = launch_counts()
    rids, steps, times, occ = _churn_workload(eng, seed=7, **kw)
    calls = eng.runner.call_counts["mixed_step"]
    per_step = step_launches(eng, steps, before)

    out = [eng.request(r).output_tokens for r in rids]
    if exact(eng):
        assert out == oracle, \
            "churn output diverged from all-resident oracle"
    assert calls == steps, (calls, steps)         # one mixed step a step
    # recompiles_after_warmup == 0 waits for the captured step (A8)
    st = eng.adapter_pool_stats()
    assert st.evictions > 0, "churn never evicted — slots not scarce?"

    rows = Rows()
    rows.add(f"adapter_churn/{arch}/step_latency",
             float(np.mean(times)) * 1e6,
             f"p50={np.median(times)*1e6:.0f}us steps={steps}",
             tokens=out, hits=[eng.request(r).n_cache_hit_tokens
                               for r in rids])
    rows.add(f"adapter_churn/{arch}/device_calls_per_step", calls / steps,
             f"calls={calls} steps={steps} launches/step: "
             f"{fmt_launches(per_step)} oracle: {agreement(out, oracle)}",
             calls=calls, steps=steps, launches=per_step,
             oracle_tokens=oracle)
    rows.add(f"adapter_churn/{arch}/adapter_pool",
             float(np.mean(occ)),
             f"slots={st.num_slots} registered={st.num_registered} "
             f"prefetch={st.prefetch_issued}/{st.prefetch_hits}hit "
             f"installs={st.installs} evictions={st.evictions} "
             f"stalled={st.stalled_installs} queued_on_slots="
             f"{st.acquire_fails}", stats=st.row())

    rec = dict(arch=arch, smoke=smoke, n_adapters=n_adapters,
               steps=steps, device_calls_per_step=calls / steps,
               launches_per_step=per_step,
               occupancy_mean=float(np.mean(occ)), **st.row())
    with open(results_path("adapter_pool.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    return rows


# ---------------------------------------------------------------------------
# Zipf thousand-adapter scheduling leg (affinity admission vs FCFS oracle)
# ---------------------------------------------------------------------------
def _zipf_trace(n_adapters: int, n_requests: int, alpha: float, seed: int):
    """Deterministic Zipf-popularity adapter index per request: adapter
    i has probability ∝ 1/(i+1)^alpha — a handful of hot adapters carry
    most traffic, a long cold tail carries the rest (S-LoRA's
    thousand-adapter regime)."""
    w = 1.0 / np.arange(1, n_adapters + 1, dtype=np.float64) ** alpha
    rng = np.random.RandomState(seed)
    return rng.choice(n_adapters, size=n_requests, p=w / w.sum())


def _zipf_workload(eng, adapter_ids, *, prompt_len: int, gen_len: int,
                   seed: int):
    """Submit the trace as a deep queue (all arrivals ~t=0, arrival
    order = trace order) and drain; returns (rids, steps, times,
    admit_step) where ``admit_step[req_id]`` is the scheduler step at
    which the request was first admitted — the DETERMINISTIC queue-wait
    measure (every request arrives before step 0, so the admission step
    IS its wait in steps)."""
    rng = np.random.RandomState(seed)
    rids = []
    for k, i in enumerate(adapter_ids):
        inv = list(eng.adapters[f"ad{i}"].spec.invocation_tokens)
        prompt = list(rng.randint(10, 400, prompt_len)) + inv
        rids.append(eng.submit(prompt, gen_len, adapter_name=f"ad{i}",
                               arrival_time=1e-9 * k))
    steps, times = 0, []
    admit_step = {}
    while eng.pending or eng.waiting or eng.running:
        dt = eng.step()
        for r in eng.running:
            admit_step.setdefault(r.req_id, steps)
        n_d, n_p = eng.last_step_tokens
        if n_d or n_p:
            steps += 1
            times.append(dt)
    return rids, steps, times, admit_step


def run_zipf(arch: str = ARCH, smoke: bool = False, device="cuda",
             n_adapters=None, n_requests=None) -> Rows:
    device = resolve_device(device)
    # max_running deliberately exceeds adapter slots: the affinity
    # scheduler fills the extra run capacity with requests sharing the
    # (Zipf-hot) pinned adapters, while strict FCFS idles it whenever
    # the queue head needs a slot no eviction can free — that idling is
    # where the measured queue-latency win comes from
    n_adapters = n_adapters or (32 if smoke else 1000)
    n_requests = n_requests or (72 if smoke else 300)
    slots = 2 if smoke else 6
    budget = 2 if smoke else 4
    max_running = 6 if smoke else 12
    prompt_len = 24 if smoke else 48
    gen_len = 8 if smoke else 12
    alpha = 1.2
    ids = _zipf_trace(n_adapters, n_requests, alpha, seed=11)
    kw = dict(prompt_len=prompt_len, gen_len=gen_len, seed=7)

    def mk(policy, n=n_adapters, n_slots=slots, staging=budget):
        return make_engine(
            "alora", n_adapters=n, arch=arch, device=device,
            ecfg=EngineConfig(max_running=max_running,
                              adapter_slots=n_slots,
                              adapter_staging_budget=staging,
                              admission_policy=policy))

    # warm-up over the full trace shape, once per policy
    for policy in ("fcfs", "affinity"):
        _zipf_workload(mk(policy), ids, prompt_len=prompt_len,
                       gen_len=gen_len, seed=999)

    # FCFS oracle, then the affinity scheduler, on the SAME trace
    runs = {}
    for policy in ("fcfs", "affinity"):
        eng = mk(policy)
        before = launch_counts()
        rids, steps, times, admit = _zipf_workload(eng, ids, **kw)
        calls = eng.runner.call_counts["mixed_step"]
        assert calls == steps, (policy, calls, steps)  # one step a step
        runs[policy] = dict(
            rids=rids, steps=steps, times=times,
            launches=step_launches(eng, steps, before),
            st=eng.adapter_pool_stats(),
            queue=eng.metrics_for(rids).means["queue"],
            wait=float(np.mean([admit[r] for r in rids])),
            tokens=[eng.request(r).output_tokens for r in rids],
            hits=[eng.request(r).n_cache_hit_tokens for r in rids])
        del eng
    # recompiles_after_warmup == 0 waits for the captured step (A8)

    # the measured win: adapter-affinity admission strictly reduces the
    # slot-contention failure modes AND queueing latency vs strict FCFS.
    # The latency comparison is in scheduler steps (deterministic on the
    # fixed trace); the virtual-clock seconds are emitted alongside.
    f, a = runs["fcfs"], runs["affinity"]
    assert a["st"].acquire_fails < f["st"].acquire_fails, \
        (a["st"].acquire_fails, f["st"].acquire_fails)
    assert a["st"].stalled_installs < f["st"].stalled_installs, \
        (a["st"].stalled_installs, f["st"].stalled_installs)
    assert a["wait"] < f["wait"], (a["wait"], f["wait"])
    # staging tier stayed bounded and never leaked a stage
    assert a["st"].staged_now == 0, a["st"].staged_now

    # equivalence oracle: with uncontended slots (one per registered
    # adapter) the two policies must produce token-for-token identical
    # outputs, whatever the admission order
    n_u = 6
    ids_u = [int(i) % n_u for i in ids[:24]]
    outs = {}
    for policy in ("fcfs", "affinity"):
        eng = mk(policy, n=n_u, n_slots=n_u, staging=None)
        rids, *_ = _zipf_workload(eng, ids_u, **kw)
        outs[policy] = [eng.request(r).output_tokens for r in rids]
    if exact(eng):
        assert outs["affinity"] == outs["fcfs"], \
            "affinity admission changed decoded tokens vs the FCFS oracle"

    rows = Rows()
    for policy, r in runs.items():
        st = r["st"]
        rows.add(f"adapter_sched/{arch}/{policy}/queue_latency",
                 r["queue"] * 1e6,
                 f"wait_steps={r['wait']:.1f} steps={r['steps']} "
                 f"acquire_fails={st.acquire_fails} "
                 f"stalls={st.stalled_installs} installs={st.installs} "
                 f"evictions={st.evictions} "
                 f"staged_dropped={st.staged_dropped} "
                 f"prefetch_deferred={st.prefetch_deferred} "
                 f"launches/step: {fmt_launches(r['launches'])}",
                 wait=r["wait"], steps=r["steps"], stats=st.row(),
                 tokens=r["tokens"], hits=r["hits"])
    rows.add(f"adapter_sched/{arch}/uncontended/fcfs_vs_affinity", 0.0,
             agreement(outs["affinity"], outs["fcfs"]), tokens=outs)
    with open(results_path("adapter_sched.jsonl"), "a") as fh:
        for policy, r in runs.items():
            rec = dict(arch=arch, smoke=smoke, policy=policy,
                       n_adapters=n_adapters, n_requests=n_requests,
                       steps=r["steps"],
                       queue_wait_steps_mean=r["wait"],
                       queue_latency_mean=r["queue"],
                       step_latency_mean=float(np.mean(r["times"])),
                       **r["st"].row())
            fh.write(json.dumps(rec) + "\n")
    return rows


if __name__ == "__main__":
    a = bench_args(__doc__.splitlines()[0], **{
        "--churn": dict(action="store_true",
                        help="adapter-lifecycle churn leg (N registered > "
                             "device slots)"),
        "--zipf": dict(action="store_true",
                       help="Zipf thousand-adapter scheduling leg "
                            "(affinity admission vs the FCFS oracle)")})
    if a.churn:
        run_churn(a.arch, smoke=a.smoke, device=a.device)
    if a.zipf:
        run_zipf(a.arch, smoke=a.smoke, device=a.device)
    if not (a.churn or a.zipf):
        run(a.arch, device=a.device)
