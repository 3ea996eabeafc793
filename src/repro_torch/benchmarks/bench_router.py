"""Multi-replica router — cache-affinity placement vs round_robin; the
reference's ``benchmarks/bench_router.py`` on the port.

The multi-turn agentic trace the paper's pipelines model (base → aLoRA
turns over a growing conversation prefix) is exactly the workload where
PLACEMENT decides the prefix-cache hit rate: turn k+1's prompt extends
turn k's full sequence, so its leading blocks are cached — but only on
the replica that served turn k.  ``serving.router.Router`` scores every
admission with the same aLoRA-aligned chained block hashes the cache
matches on (``Engine.cached_prefix_tokens``, non-acquiring), so later
turns follow their prefix; ``round_robin`` sprays turns across the
fleet and re-prefills prefixes some other replica already holds.

For each fleet size R (1, 2, 4; smoke: 1, 2) this runs the SAME
multi-session multi-adapter trace under both policies and reports, per
policy: the fleet prefix-cache hit rate (affinity must beat round_robin
for R > 1, asserted), the fleet tokens/s through ``metrics_for`` →
``merge_aggregates`` (replica virtual clocks advance independently, so
the fleet models R engines stepping concurrently), and a row per
replica.  R = 1 is the degenerate sanity leg: both policies are the one
engine and must match its hit rate exactly.  The replicas of a fleet
share one copy of the weights.  Appends one record per (R, policy) to
``results/torch/router.jsonl``.
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.benchmarks.common import (ARCH, Rows, bench_args,
                                           make_engine, model, results_path,
                                           stage_row)
from repro_torch.common import resolve_device
from repro_torch.serving import EngineConfig
from repro_torch.serving.router import Router

# session counts are COPRIME to every fleet size: with sessions % R == 0
# a round_robin pointer that cycles straight through each round would
# map every session back to the replica that served its previous turn —
# accidental perfect affinity, and the policy contrast measures nothing.
SESSIONS = 9
TURNS = 3
BASE_PROMPT = 40
TURN_TOKENS = 24
GEN_LEN = 8


def _mk_router(n: int, policy: str, arch: str, device) -> Router:
    # identical construction per replica (same params + adapter weights,
    # fresh pools) — registration order matches, so the uid every block
    # hash salts on agrees across the fleet
    ecfg = EngineConfig(max_running=4, max_batched_tokens=64,
                        adapter_slots=2)
    return Router([make_engine("alora", n_adapters=2, ecfg=ecfg,
                               arch=arch, device=device)
                   for _ in range(n)], policy=policy)


def _run_trace(router: Router, arch: str, seed: int, sessions: int,
               turns: int, device="cuda"):
    """Drive the multi-turn trace; returns every router-global req id.

    Turn k+1 extends turn k's prompt + generated tokens, alternating
    base and aLoRA turns per session.  No ``session=`` pinning —
    placement quality must come from the locality SCORE alone."""
    cfg, _ = model(arch, device)
    rng = np.random.RandomState(seed)
    hi = min(400, cfg.vocab_size)
    convo = [list(rng.randint(10, hi, BASE_PROMPT + 4 * (s % 3)))
             for s in range(sessions)]
    gids = []
    for t in range(turns):
        round_ids = []
        for s in range(sessions):
            adapter = f"ad{s % 2}" if t % 2 else None
            round_ids.append(router.submit(convo[s], GEN_LEN,
                                           adapter_name=adapter))
        router.run_until_idle()
        for s, gid in enumerate(round_ids):
            out = router.request(gid).output_tokens
            assert len(out) == GEN_LEN, (s, out)
            convo[s] = convo[s] + list(out) \
                + list(rng.randint(10, hi, TURN_TOKENS))
        gids.extend(round_ids)
    return gids


def run(arch: str = ARCH, smoke: bool = False, device="cuda",
        fleet_sizes=None) -> Rows:
    device = resolve_device(device)
    fleet_sizes = fleet_sizes or ((1, 2) if smoke else (1, 2, 4))
    sessions = 5 if smoke else SESSIONS
    turns = 2 if smoke else TURNS
    hit_rates: dict = {}
    rows = Rows()
    for n in fleet_sizes:
        for policy in ("affinity", "round_robin"):
            for seed in (999, 7):                 # warmup + measured
                router = _mk_router(n, policy, arch, device)
                gids = _run_trace(router, arch, seed, sessions, turns,
                                  device)
            fleet = router.metrics_for(gids)
            per = router.per_replica_metrics(gids)
            hit = router.kv_hit_rate()
            hit_rates[(n, policy)] = hit
            tag = f"R{n}/{policy}"
            rows.add(f"router/{arch}/{tag}/fleet_hit_rate", hit * 100,
                     f"hits/lookups across {n} replica(s); "
                     f"{len(gids)} requests", hit_rate=hit,
                     placements=[(p.replica, p.cached_tokens)
                                 for p in router.placements],
                     tokens=[list(router.request(g).output_tokens)
                             for g in gids])
            rows.add(f"router/{arch}/{tag}/fleet_tok_per_s",
                     fleet.throughput_tok_per_s,
                     f"union-makespan throughput; {stage_row(fleet)}")
            for idx, agg in sorted(per.items()):
                eng = router.replicas[idx]
                rows.add(f"router/{arch}/{tag}/replica{idx}",
                         agg.throughput_tok_per_s,
                         f"n={agg.n} hit={eng.kv_hit_rate():.2f} "
                         f"{stage_row(agg)}")
            rec = dict(arch=arch, smoke=smoke, replicas=n, policy=policy,
                       fleet_hit_rate=hit,
                       fleet_tok_per_s=fleet.throughput_tok_per_s,
                       mean_ttft_s=fleet.means.get("ttft"),
                       n_requests=len(gids),
                       per_replica_n=[per[i].n if i in per else 0
                                      for i in range(n)],
                       reroutes=router.reroutes)
            with open(results_path("router.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")
            del router
        a, rr = hit_rates[(n, "affinity")], hit_rates[(n, "round_robin")]
        if n == 1:
            # R=1: both policies ARE the single engine — identical trace,
            # identical placement, identical hit rate
            assert abs(a - rr) < 1e-12, (a, rr)
        else:
            # the routing win this benchmark exists to show: locality
            # scoring must strictly beat blind placement on a multi-turn
            # trace
            assert a > rr, \
                f"R={n}: affinity hit rate {a:.3f} <= round_robin {rr:.3f}"
            rows.add(f"router/{arch}/R{n}/affinity_vs_round_robin",
                     (a / rr if rr else float("inf")) * 100,
                     f"hit-rate ratio: affinity={a:.3f} "
                     f"round_robin={rr:.3f}")
    return rows


if __name__ == "__main__":
    a = bench_args(__doc__.splitlines()[0])
    run(a.arch, a.smoke, a.device)
