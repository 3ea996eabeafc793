"""Render the port's tables from its JSONL artifacts under
``results/torch/``, the counterpart of the reference's
``benchmarks/report.py`` (the same tables, the same append-mode
artifacts, last record per key wins).

  PYTHONPATH=src python -m repro_torch.benchmarks.report   # markdown

The dry run's records (``repro_torch.launch.dryrun``) carry no
activation estimate: the temp column prints "–", and an args column
gives the rank's argument bytes against the card's 80 GB.  A table
whose artifact is absent prints nothing: the compiled-step audit waits
for ``analysis_audit.jsonl``'s compiled-step records.
"""
from __future__ import annotations

import json
import os

from repro_torch.benchmarks.common import RESULTS as BASE


def fmt(v, spec=".2f"):
    """NaN/None-safe cell formatter: empty pipeline stages aggregate to
    NaN (``MetricsAggregate.row``) and must render as ``-``, not crash
    the report."""
    if v is None or (isinstance(v, float) and v != v):
        return "-"
    return format(v, spec)


def load(path):
    recs = []
    if os.path.exists(path):
        with open(path) as f:
            recs = [json.loads(line) for line in f]
    return recs


def fmt_mem(r):
    """The rank's temp GiB: None (not estimated by the port's dry run)
    renders as "-"."""
    t = r["memory"].get("temp_size_in_bytes")
    return None if t is None else t / 2 ** 30


def fmt_args(r):
    return r["memory"]["argument_size_in_bytes"] / 2 ** 30


def roofline_table(recs, title):
    print(f"\n### {title}\n")
    print("| arch | shape | compute (s) | memory (s) | collective (s) | "
          "dominant | useful | args GiB/rank | temp GiB/rank |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in sorted(recs, key=lambda r: (r["shape"], r["arch"])):
        if not r["ok"]:
            print(f"| {r['arch']} | {r['shape']} | — | — | — | FAILED | "
                  f"— | — | — |")
            continue
        ro = r["roofline"]
        print(f"| {r['arch']} | {r['shape']} | {ro['compute_s']:.3e} | "
              f"{ro['memory_s']:.3e} | {ro['collective_s']:.3e} | "
              f"**{ro['dominant']}** | {ro['useful_flops_ratio']:.2f} | "
              f"{fmt_args(r):.2f} | {fmt(fmt_mem(r), '.1f')} |")


def dryrun_matrix(pod, multipod):
    print("\n### Dry-run matrix (sized per rank)\n")
    shapes = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    archs = sorted({r["arch"] for r in pod})
    idx = {(r["arch"], r["shape"], r["mesh"]): r for r in pod + multipod}
    print("| arch | " + " | ".join(f"{s} 16×16 / 2×16×16" for s in shapes)
          + " |")
    print("|---|" + "---|" * len(shapes))
    for a in archs:
        cells = []
        for s in shapes:
            p = idx.get((a, s, "16x16"))
            m = idx.get((a, s, "2x16x16"))
            cell = ("✓" if p and p["ok"] else "✗") + " / " + \
                   ("✓" if m and m["ok"] else "✗")
            cells.append(cell)
        print(f"| {a} | " + " | ".join(cells) + " |")


def perf_table(perf, base_idx):
    print("\n### §Perf variants vs baseline\n")
    print("| arch | shape | variant | compute | memory | collective | "
          "dominant | temp GiB |")
    print("|---|---|---|---|---|---|---|---|")
    for r in perf:
        if not r["ok"]:
            print(f"| {r['arch']} | {r['shape']} | {r.get('tag')} | "
                  f"FAILED: {r.get('error','')[:60]} | | | | |")
            continue
        b = base_idx.get((r["arch"], r["shape"], "16x16"))
        ro, bo = r["roofline"], b["roofline"] if b else None

        def delta(k):
            if not bo or not bo[k]:
                return f"{ro[k]:.3e}"
            return f"{ro[k]:.3e} ({ro[k]/bo[k]:.2f}×)"

        row_base = f"| {r['arch']} | {r['shape']} | baseline | " \
            f"{bo['compute_s']:.3e} | {bo['memory_s']:.3e} | " \
            f"{bo['collective_s']:.3e} | {bo['dominant']} | " \
            f"{fmt(fmt_mem(b), '.1f')} |" if bo else ""
        if row_base:
            print(row_base)
        print(f"| {r['arch']} | {r['shape']} | **{r.get('tag')}** | "
              f"{delta('compute_s')} | {delta('memory_s')} | "
              f"{delta('collective_s')} | {ro['dominant']} | "
              f"{fmt(fmt_mem(r), '.1f')} |")


def adapter_pool_table(recs):
    """Adapter-lifecycle counters from the churn benchmark
    (``bench_multi_adapter.py --churn`` appends one record per run)."""
    print("\n### Adapter pool — lifecycle counters (churn runs)\n")
    print("| arch | slots | registered | calls/step | recompiles | "
          "prefetch iss/hit | installs | evictions | stalled | "
          "occupancy |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for r in recs:
        print(f"| {r['arch']} | {r['num_slots']:.0f} | "
              f"{r['num_registered']:.0f} | "
              f"{r['device_calls_per_step']:.2f} | "
              f"{r['recompiles_after_warmup']} | "
              f"{r['prefetch_issued']:.0f}/{r['prefetch_hits']:.0f} | "
              f"{r['installs']:.0f} | {r['evictions']:.0f} | "
              f"{r['stalled_installs']:.0f} | "
              f"{r['occupancy_mean']:.2f} |")


def adapter_sched_table(recs):
    """Admission-scheduling comparison from the Zipf thousand-adapter
    leg (``bench_multi_adapter.py --zipf`` appends one record per
    policy): the adapter-affinity scheduler vs the strict-FCFS oracle
    on the same trace.  Queue wait is in scheduler steps (deterministic
    on the fixed trace); acquire-fails/stalls/installs are the
    slot-contention failure modes affinity admission exists to avoid."""
    print("\n### Admission scheduling — affinity vs FCFS (Zipf trace)\n")
    print("| arch | policy | adapters | requests | steps | "
          "queue wait (steps) | acquire fails | stalls | installs | "
          "evictions | staged dropped |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for r in sorted(recs, key=lambda r: (r["arch"], r["policy"])):
        print(f"| {r['arch']} | {r['policy']} | "
              f"{r['n_adapters']} | {r['n_requests']} | {r['steps']} | "
              f"{r['queue_wait_steps_mean']:.1f} | "
              f"{r['acquire_fails']:.0f} | {r['stalled_installs']:.0f} | "
              f"{r['installs']:.0f} | {r['evictions']:.0f} | "
              f"{r['staged_dropped']:.0f} |")


def sharded_step_table(recs):
    """TP-sharded mixed-step runs (``bench_mixed_batch.py --mesh …``
    appends one record per run).  Latency vs the single-device mixed
    baseline of the same invocation; on host meshes the ratio gauges
    collective overhead, not TP speedup."""
    print("\n### Sharded mixed step — host-mesh runs\n")
    print("| arch | mesh (data×model) | tok-shard | step (us) | "
          "single-dev (us) | ratio | assembly (us) | calls/step | "
          "recompiles |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in recs:
        ratio = r["step_latency_us"] / r["baseline_us"] \
            if r.get("baseline_us") and r.get("step_latency_us") \
            is not None else float("nan")
        print(f"| {r['arch']} | {r['mesh']} | "
              f"{'✓' if r.get('data_shard') else '—'} | "
              f"{fmt(r.get('step_latency_us'), '.0f')} | "
              f"{fmt(r.get('baseline_us'), '.0f')} | "
              f"{fmt(ratio)}× | "
              f"{fmt(r.get('assembly_us_per_step'), '.0f')} | "
              f"{fmt(r.get('device_calls_per_step'))} | "
              f"{r['recompiles_after_warmup']} |")


def router_table(recs):
    """Multi-replica router runs (``bench_router.py`` appends one record
    per replicas × policy).  Fleet throughput uses the merged makespan
    (overlapped replica wall-clock counted once); the hit rate is the
    fleet's summed hits over summed lookups.  The affinity-vs-
    round_robin contrast at the same R is the routing win."""
    print("\n### Multi-replica router — affinity vs round_robin\n")
    print("| arch | R | policy | fleet hit rate | fleet tok/s | "
          "mean ttft (s) | per-replica n | reroutes |")
    print("|---|---|---|---|---|---|---|---|")
    for r in sorted(recs, key=lambda r: (r["arch"], r["replicas"],
                                         r["policy"])):
        per_n = "/".join(str(n) for n in r.get("per_replica_n", []))
        print(f"| {r['arch']} | {r['replicas']} | {r['policy']} | "
              f"{fmt(r.get('fleet_hit_rate'))} | "
              f"{fmt(r.get('fleet_tok_per_s'), '.0f')} | "
              f"{fmt(r.get('mean_ttft_s'), '.4f')} | {per_n or '—'} | "
              f"{r.get('reroutes', 0)} |")


def d2h_table(recs):
    """Device→host payloads from the runner's ``log_d2h`` ring
    (``bench_mixed_batch.py`` appends one obs record per measured
    mode).  The paper-critical row is tag ``step``: sampled int32 ids
    only, a handful of elements per step — never ``(R, vocab)``
    logits."""
    print("\n### D2H payloads — runner `log_d2h` ring\n")
    print("| arch | mode | tag | transfers | elems | KiB | elems/step |")
    print("|---|---|---|---|---|---|---|")
    for r in recs:
        steps = max(r.get("steps", 0), 1)
        for tag in sorted(r.get("d2h", {})):
            row = r["d2h"][tag]
            print(f"| {r['arch']} | {r['mode']} | {tag} | "
                  f"{row['count']:.0f} | {row['elems']:.0f} | "
                  f"{row['bytes'] / 1024:.1f} | "
                  f"{row['elems'] / steps:.1f} |")


def reuse_table(recs):
    """Cache-reuse ledger rolled up per adapter (the paper's central
    quantity): tokens whose KV the admission probe reused from another
    adapter's (or the base model's) cache vs tokens it had to
    recompute."""
    rows = [(r, uid) for r in recs for uid in sorted(r.get("reuse", {}))]
    if not rows:
        return
    print("\n### Cache-reuse ledger — per adapter\n")
    print("| arch | mode | adapter | admissions | tok reused | "
          "tok recomputed | reuse frac | state reuses |")
    print("|---|---|---|---|---|---|---|---|")
    for r, uid in rows:
        row = r["reuse"][uid]
        print(f"| {r['arch']} | {r['mode']} | {uid} | "
              f"{row['admissions']:.0f} | {row['reused']:.0f} | "
              f"{row['recomputed']:.0f} | {row['reuse_frac']:.2f} | "
              f"{row['state_reuses']:.0f} |")


def trace_overhead_table(recs):
    """Tracer on/off A-B (``bench_mixed_batch.py --trace-check``): the
    observability layer's cost against its <2% budget."""
    print("\n### Tracing overhead — tracer on vs off\n")
    print("| arch | traced (us) | untraced (us) | overhead | events |")
    print("|---|---|---|---|---|")
    for r in recs:
        print(f"| {r['arch']} | {fmt(r.get('traced_us'), '.0f')} | "
              f"{fmt(r.get('untraced_us'), '.0f')} | "
              f"{fmt(r.get('overhead_pct'))}% | "
              f"{r.get('events', 0)} |")


def audit_table(recs):
    """Compiled-step audit summary (the reference's ``python -m
    repro.analysis`` appends
    one record per config × mesh).  "donated HBM" is the pool footprint
    XLA aliases in-place thanks to ``donate_argnums`` — without donation
    that many bytes would be allocated a second time every step."""
    print("\n### Compiled-step invariant audit\n")
    print("| arch | mesh | status | donated outputs | donated HBM (KiB) "
          "| output HBM (KiB) | collectives | sync≡async |")
    print("|---|---|---|---|---|---|---|---|")
    for r in sorted(recs, key=lambda r: (r["arch"], r["mesh"])):
        mem = r.get("memory") or {}
        alias_kib = mem.get("alias_size_bytes")
        out_kib = mem.get("output_size_bytes")
        colls = ", ".join(f"{k}×{v}"
                          for k, v in sorted(
                              r["fingerprint"]["counts"].items())) or "—"
        status = "ok" if r["ok"] else \
            f"**FAIL** ({len(r['violations'])} violation(s)" + \
            (", fingerprint drift)" if r.get("fingerprint_drift")
             else ")")
        print(f"| {r['arch']} | {r['mesh']} | {status} | "
              f"{', '.join(r['donated']) or '—'} | "
              f"{fmt(alias_kib / 1024 if alias_kib is not None else None, '.0f')} | "
              f"{fmt(out_kib / 1024 if out_kib is not None else None, '.0f')} | "
              f"{colls} | "
              f"{'✓' if r.get('sync_async_identical') else '✗'} |")


def static_pass_table(recs):
    """Static-analysis summary records (``python -m repro_torch.analysis
    --json`` appends one per pass): the hot-path lint (Pass B) and the
    resource-lifecycle check (Pass C).  A red row here means the
    scheduler can leak KV blocks / state slots / adapter pins / staged
    weights on some exit path — the class of bug behind five historical
    incidents."""
    print("\n### Static analysis — hot-path lint + lifecycle check\n")
    print("| pass | status | violations |")
    print("|---|---|---|")
    names = {"hotpath_lint": "hot-path lint (Pass B)",
             "lifecycle_check": "resource lifecycle (Pass C)"}
    for r in sorted(recs, key=lambda r: r["kind"]):
        first = r["violations"][0] if r.get("violations") else ""
        status = "ok" if r["ok"] else \
            f"**FAIL** ({r.get('n_violations', len(r.get('violations', [])))})"
        print(f"| {names.get(r['kind'], r['kind'])} | {status} | "
              f"{first or '—'} |")


def main(device=None):
    """``device`` is accepted for ``benchmarks.run``'s sections and
    unused."""
    pod = load(os.path.join(BASE, "dryrun_all.jsonl"))
    # dedup: last record per key wins
    seen = {}
    for r in pod:
        seen[(r["arch"], r["shape"], r["mesh"])] = r
    pod = list(seen.values())
    multipod = load(os.path.join(BASE, "dryrun_multipod.jsonl"))
    perf = load(os.path.join(BASE, "perf.jsonl"))
    dryrun_matrix(pod, multipod)
    roofline_table([r for r in pod if r["mesh"] == "16x16"],
                   "Roofline — single pod (16×16), baseline")
    if perf:
        base_idx = {(r["arch"], r["shape"], r["mesh"]): r for r in pod}
        perf_table(perf, base_idx)
    pool = load(os.path.join(BASE, "adapter_pool.jsonl"))
    if pool:
        # append-mode artifact: last record per (arch, smoke) wins
        latest = {}
        for r in pool:
            latest[(r["arch"], r["smoke"])] = r
        adapter_pool_table(list(latest.values()))
    sched = load(os.path.join(BASE, "adapter_sched.jsonl"))
    if sched:
        # append-mode artifact: last record per (arch, policy, smoke)
        # wins
        latest = {}
        for r in sched:
            latest[(r["arch"], r["policy"], r["smoke"])] = r
        adapter_sched_table(list(latest.values()))
    sharded = load(os.path.join(BASE, "sharded_step.jsonl"))
    if sharded:
        # append-mode artifact: last record per
        # (arch, mesh, smoke, data_shard) wins
        latest = {}
        for r in sharded:
            latest[(r["arch"], r["mesh"], r["smoke"],
                    r.get("data_shard", False))] = r
        sharded_step_table(list(latest.values()))
    router = load(os.path.join(BASE, "router.jsonl"))
    if router:
        # append-mode artifact: last record per
        # (arch, replicas, policy, smoke) wins
        latest = {}
        for r in router:
            latest[(r["arch"], r["replicas"], r["policy"],
                    r["smoke"])] = r
        router_table(list(latest.values()))
    obs = load(os.path.join(BASE, "obs.jsonl"))
    if obs:
        # append-mode artifact: last record per (arch, smoke, mode) wins
        latest = {}
        for r in obs:
            latest[(r["arch"], r["smoke"], r["mode"])] = r
        obs = sorted(latest.values(),
                     key=lambda r: (r["arch"], r["mode"]))
        d2h_table(obs)
        reuse_table(obs)
    overhead = load(os.path.join(BASE, "trace_overhead.jsonl"))
    if overhead:
        # append-mode artifact: last record per (arch, smoke) wins
        latest = {}
        for r in overhead:
            latest[(r["arch"], r["smoke"])] = r
        trace_overhead_table(sorted(latest.values(),
                                    key=lambda r: r["arch"]))
    audit = load(os.path.join(BASE, "analysis_audit.jsonl"))
    if audit:
        # the append-mode artifact interleaves compiled-step records
        # (keyed arch × mesh) with static-pass summary records (keyed
        # by pass kind, from --json); split before deduping
        compiled = [r for r in audit if "arch" in r]
        static = [r for r in audit
                  if r.get("kind") in ("hotpath_lint",
                                       "lifecycle_check")]
        if compiled:
            # last record per (arch, mesh) wins
            latest = {}
            for r in compiled:
                latest[(r["arch"], r["mesh"])] = r
            audit_table(list(latest.values()))
        if static:
            # last record per pass wins
            latest = {}
            for r in static:
                latest[r["kind"]] = r
            static_pass_table(list(latest.values()))


if __name__ == "__main__":
    main()
