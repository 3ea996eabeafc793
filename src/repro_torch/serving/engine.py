"""The serving engine: scheduler + continuous batching + chunked prefill +
cross-model prefix caching (the paper's system, §3), ported from the
reference's ``repro/serving/engine.py`` for attention (dense or
mixture-of-experts MLPs, optionally behind an image-patch prefix), SSM,
hybrid and encoder-decoder stacks (an audio request's encoder runs once
at admission; its cross K/V stay in its run slot until it finishes or is
preempted).

Request flow (paper Fig. 5): submit → [queue] → admission (prefix-cache
match on base-aligned block hashes and SSM state snapshots) → chunked
prefill (budgeted per step, interleaved with decodes) → decode → done.
The engine runs a discrete-event loop with a virtual clock that advances
by the measured wall time of each step.

Cross-model reuse appears in two places: admission matches the
request's ``AdapterKey``, so aLoRA requests hit blocks the base model or
sibling adapters prefilled (and vice versa); and every block filled,
during prefill or decode, is registered under its base-aligned hash.
On SSM and hybrid stacks the recurrent state at each such block boundary
is snapshotted too (``st_mgr``), so an aLoRA request restores the state
the base request left at the same boundary as its KV blocks.

Each iteration is a **schedule → submit → retire** pipeline
(``Engine.step``): sampling runs on the device inside the mixed step,
so with ``EngineConfig.async_submission`` (the default) step N+1 is
scheduled, assembled and enqueued BEFORE step N's sampled ids are
fetched, and the only per-step device→host payload is a handful of
int32 ids.  ``EngineConfig(execution_mode="sequential")`` runs the
reference's oracle of that path instead: the same schedule, executed as
one device call per decode batch and one per prefill chunk, each
synchronous and returning whole logits to the host.

``EngineConfig.mesh`` serves the mixed step tensor-parallel over a
``(data, model)`` ``DeviceMesh`` of ``torch.distributed`` ranks
(``launch.mesh.make_host_mesh``), optionally token-sharded over
``data`` (``data_shard_tokens``).  Every rank runs this same engine over
the same requests, so the block manager, the prefix cache, the adapter
registry and the pool decisions stay identical on every rank as long as
the virtual clock does: under a mesh it advances by rank 0's measured
wall time, broadcast over a CPU group (admission reads ``arrival_time
<= clock``; ranks that admitted different requests would deadlock in
the step's next collective).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from itertools import islice
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.activation_mask import (adapter_index_for_positions,
                                              find_invocation_start)
from repro_torch.core.alora import AdapterSpec
from repro_torch.core.block_hash import (AdapterKey, block_extra,
                                         hash_block, request_block_hashes)
from repro_torch.core.kv_manager import BlockManager, OutOfBlocks
from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.models.model import check_supported
from repro_torch.obs.tracer import Tracer
from repro_torch.serving.adapter_pool import (AdapterPool,
                                              AdapterRegistration,
                                              rank_bucket, slot_rank_for)
from repro_torch.serving.metrics import (AdapterPoolStats, MetricsAggregate,
                                         aggregate)
from repro_torch.serving.request import Request, State
from repro_torch.serving.runner import (MixedBatch, ModelRunner,
                                        RunnerConfig, StepHandle)

# placeholder a submitted-but-unretired step leaves in output_tokens: the
# token's VALUE is still on the device (patched at retire); its position
# already counts for scheduling.  Never a valid vocab id.
PENDING = -1


def _activation_start(prompt: Sequence[int], spec: AdapterSpec) -> int:
    """Where an aLoRA request's adapter activates: its last invocation
    sequence, or the end of the prompt when the sequence is absent."""
    inv = find_invocation_start(prompt, spec.invocation_tokens)
    return len(prompt) if inv is None else inv


@dataclass
class _InflightStep:
    """A submitted mixed step awaiting retirement: the device handle plus,
    per request row, ``(request, epoch-at-submit, sampled-row index,
    output_tokens patch index | None, decode block-boundary position |
    None, state-snapshot slot claimed for that boundary | None)``."""
    handle: StepHandle
    retires: List[Tuple[Request, int, int, Optional[int], Optional[int],
                        Optional[int]]]


@dataclass(frozen=True)
class EngineConfig:
    block_size: int = 16
    num_blocks: int = 512
    max_running: int = 8
    # SSM state-snapshot slots (SSM and hybrid stacks)
    num_state_slots: int = 64
    max_batched_tokens: int = 128     # chunked-prefill budget per step
    enable_prefix_cache: bool = True
    # "mixed": one device step over every scheduled token; "sequential":
    # one call per decode batch and per prefill chunk, synchronous (the
    # mixed path's equivalence oracle)
    execution_mode: str = "mixed"
    # device-resident adapter slots (None -> one per construction-time
    # adapter) and the rank bucket they pad into (None -> pow2 bucket of
    # the largest construction-time rank, min 8)
    adapter_slots: Optional[int] = None
    adapter_slot_rank: Optional[int] = None
    # "affinity": windowed adapter-aware admission; "fcfs": strict queue
    # order with head-of-line break (the equivalence oracle)
    admission_policy: str = "affinity"
    admission_window: int = 32
    admission_starvation_cap: int = 8
    # staging tier of the adapter pool (None -> one per slot) and its TTL
    adapter_staging_budget: Optional[int] = None
    adapter_staging_ttl: int = 64
    adapter_evict_policy: Optional[Callable[[Sequence[str]], str]] = None
    # one-step-lookahead submission; False retires every step before the
    # next is scheduled (the synchronous oracle).  Mixed mode only
    async_submission: bool = True
    # the virtual clock advances by measured wall time times this factor
    time_scale: float = 1.0
    # None follows REPRO_TRACE (on unless "0")
    trace: Optional[bool] = None
    # tensor-parallel serving: the (data, model) DeviceMesh this process
    # is one rank of (mixed mode only), and whether the packed token axis
    # splits over its data axis
    mesh: Optional[object] = None
    data_shard_tokens: bool = True


class _RankZeroClock:
    """Every rank's clock step is rank 0's measured wall time, broadcast
    over a CPU (gloo) group: the ranks' schedules then never diverge."""

    def __init__(self):
        # gloo moves CPU tensors; an NCCL world needs a gloo group beside
        self.group = None if dist.get_backend() == "gloo" \
            else dist.new_group(backend="gloo")
        self.buf = torch.zeros(1, dtype=torch.float64)

    def __call__(self, dt: float) -> float:
        self.buf[0] = dt
        dist.broadcast(self.buf, src=0, group=self.group)
        return float(self.buf[0])

class Engine:
    def __init__(self, cfg: ModelConfig, params, *,
                 engine_cfg: EngineConfig = EngineConfig(),
                 adapters: Optional[List[Tuple[AdapterSpec, dict]]] = None,
                 device="cuda"):
        check_supported(cfg)
        if engine_cfg.execution_mode not in ("mixed", "sequential"):
            raise ValueError(f"unknown execution_mode "
                             f"{engine_cfg.execution_mode!r}: expected "
                             "'mixed' or 'sequential'")
        if engine_cfg.admission_policy not in ("affinity", "fcfs"):
            raise ValueError(f"unknown admission_policy "
                             f"{engine_cfg.admission_policy!r}: "
                             "expected 'affinity' or 'fcfs'")
        if engine_cfg.admission_window < 1 \
                or engine_cfg.admission_starvation_cap < 1:
            raise ValueError("admission_window and "
                             "admission_starvation_cap must be >= 1")
        mesh = engine_cfg.mesh
        if mesh is not None and engine_cfg.execution_mode != "mixed":
            raise ValueError("a sharded engine (EngineConfig.mesh) serves "
                             "the mixed execution mode only")
        self.cfg = cfg
        self.ecfg = engine_cfg
        adapters = adapters or []
        self.tracer = Tracer(enabled=engine_cfg.trace)
        self.adapter_pool: Optional[AdapterPool] = None
        if adapters or engine_cfg.adapter_slots is not None:
            n_slots = engine_cfg.adapter_slots \
                if engine_cfg.adapter_slots is not None \
                else max(len(adapters), 1)
            slot_rank = slot_rank_for(
                engine_cfg.adapter_slot_rank
                if engine_cfg.adapter_slot_rank is not None
                else rank_bucket(max((s.rank for s, _ in adapters),
                                     default=1)), device)
            self.adapter_pool = AdapterPool(
                cfg, num_slots=n_slots, slot_rank=slot_rank, device=device,
                tracer=self.tracer,
                staging_budget=engine_cfg.adapter_staging_budget,
                staging_ttl=engine_cfg.adapter_staging_ttl,
                evict_policy=engine_cfg.adapter_evict_policy, mesh=mesh)
            for spec, w in adapters:
                self.adapter_pool.register(spec, w)
        rcfg = RunnerConfig(block_size=engine_cfg.block_size,
                            num_blocks=engine_cfg.num_blocks + 1,
                            max_running=engine_cfg.max_running + 1,
                            num_state_slots=engine_cfg.num_state_slots + 1)
        self.runner = ModelRunner(
            cfg, params, rcfg,
            self.adapter_pool.layers if self.adapter_pool else None,
            device=device, tracer=self.tracer, mesh=mesh,
            data_shard_tokens=engine_cfg.data_shard_tokens)
        self._rank_clock = None if mesh is None else _RankZeroClock()
        # each manager exists only when its kind of layer does
        self.kv_mgr = BlockManager(engine_cfg.num_blocks,
                                   engine_cfg.block_size) \
            if self.runner.La else None
        self.st_mgr = BlockManager(engine_cfg.num_state_slots,
                                   engine_cfg.block_size) \
            if self.runner.Ls else None
        self.cache = PrefixCache(block_size=engine_cfg.block_size,
                                 kv_manager=self.kv_mgr,
                                 state_manager=self.st_mgr) \
            if engine_cfg.enable_prefix_cache else None

        self.clock = 0.0
        self._next_id = 0
        self.pending: "deque[Request]" = deque()   # future arrivals (sorted)
        self.waiting: "deque[Request]" = deque()   # arrived, not admitted
        self.running: List[Request] = []
        self.done: List[Request] = []
        self._free_slots = list(range(engine_cfg.max_running))
        self._budget_debt = 0                 # min-progress overdraft
        self.preemptions = 0
        self.last_step_tokens = (0, 0)        # (n_decode, n_prefill)
        self.t_assembly = 0.0                 # host-side batch-pack time
        self.use_mixed = engine_cfg.execution_mode == "mixed"
        self.use_async = self.use_mixed and engine_cfg.async_submission
        self._inflight: Optional[_InflightStep] = None
        # steps scheduled and assembled while the previous one was still
        # on the device (the overlap the pipeline exists for)
        self.async_overlap_steps = 0

    def _advance_clock(self, t0: float) -> None:
        """Advance the virtual clock by the wall time since ``t0`` (rank
        0's, under a mesh) times ``time_scale``."""
        dt = (time.perf_counter() - t0) * self.ecfg.time_scale
        if self._rank_clock is not None:
            dt = self._rank_clock(dt)
        self.clock += dt

    # ------------------------------------------------------------------
    # adapter lifecycle (delegates to the AdapterPool)
    # ------------------------------------------------------------------
    @property
    def adapters(self) -> Dict[str, AdapterRegistration]:
        pool = self.adapter_pool
        if pool is None:
            return {}
        return {name: pool.get(pool.uid_of(name))
                for name in pool.registered}

    def register_adapter(self, spec: AdapterSpec, weights) -> str:
        if self.adapter_pool is None:
            raise RuntimeError(
                "engine was built without an adapter pool; pass "
                "adapters=... at construction or set "
                "EngineConfig.adapter_slots")
        return self.adapter_pool.register(spec, weights)

    def unregister_adapter(self, name: str) -> None:
        """Drop a registration; refuses while a live request uses it."""
        if self.adapter_pool is None:
            raise KeyError(name)
        uid = self.adapter_pool.uid_of(name)
        for group in (self.running, self.waiting, self.pending):
            if any(r.adapter_uid == uid for r in group):
                raise RuntimeError(
                    f"adapter {name!r} still referenced by live requests")
        self.adapter_pool.unregister(name)

    def adapter_pool_stats(self) -> AdapterPoolStats:
        if self.adapter_pool is None:
            return AdapterPoolStats()
        return self.adapter_pool.stats()

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               adapter_name: Optional[str] = None,
               arrival_time: Optional[float] = None,
               prefix_embeds: Optional[np.ndarray] = None,
               frame_embeds: Optional[np.ndarray] = None,
               salt: Tuple = ()) -> int:
        """Queue a request.  ``prefix_embeds`` (P, d): image-patch
        embeddings that take the place of the prompt's leading P rows
        (the prompt holds P pseudo-token ids there for hashing);
        ``frame_embeds`` (Se, d): an encoder-decoder request's audio
        frames, which every decoder layer cross-attends to.  Give the
        image's or the audio's content digest as ``salt`` so that its
        blocks are reused only for the same content."""
        if self.cfg.is_encoder_decoder and frame_embeds is None:
            raise ValueError(f"{self.cfg.name} serves requests with "
                             "frame_embeds")
        req = Request(req_id=self._next_id,
                      prompt=list(map(int, prompt)),
                      max_new_tokens=max_new_tokens,
                      arrival_time=self.clock if arrival_time is None
                      else arrival_time,
                      prefix_embeds=prefix_embeds,
                      frame_embeds=frame_embeds, salt=salt)
        self._next_id += 1
        if adapter_name is not None:
            pool = self.adapter_pool
            if pool is None:
                raise KeyError(adapter_name)
            uid = pool.uid_of(adapter_name)
            ra = pool.get(uid)
            req.adapter = ra.spec
            req.adapter_uid = uid       # stable cache identity; the
            req.adapter_slot = 0        # device slot is pinned at admission
            if ra.spec.kind == "alora":
                req.inv_start = _activation_start(req.prompt, ra.spec)
        if req.arrival_time <= self.clock:
            self.waiting.append(req)
        else:
            self.pending.append(req)
            if len(self.pending) > 1 \
                    and req.arrival_time < self.pending[-2].arrival_time:
                self.pending = deque(sorted(
                    self.pending, key=lambda r: r.arrival_time))
        if self.tracer.enabled:
            req.t_submit_wall = time.perf_counter()
            self.tracer.event("lifecycle", "arrival", req.arrival_time,
                              {"req_id": req.req_id,
                               "prompt_len": len(req.prompt),
                               "adapter_uid": req.adapter_uid})
        return req.req_id

    # ------------------------------------------------------------------
    # admission: prefix-cache match + block allocation
    # ------------------------------------------------------------------
    def _try_admit(self, req: Request) -> bool:
        """One admission attempt, traced as an ``admit`` span; the first
        that succeeds stamps the request's ``t_admit_wall``."""
        tr = self.tracer
        if not tr.enabled:
            return self._admit(req) is not None
        t0 = time.perf_counter()
        got = self._admit(req)
        t1 = time.perf_counter()
        if got is not None and req.t_admit_wall is None:
            req.t_admit_wall = t1
        reused, new_blocks = got or (0, 0)
        tr.span("schedule", "admit", t0, t1, self.clock,
                {"req_id": req.req_id, "ok": got is not None,
                 "reused": reused, "new_blocks": new_blocks,
                 "step": tr.step})
        return got is not None

    def _admit(self, req: Request) -> Optional[Tuple[int, int]]:
        """Admit ``req`` if its blocks, adapter slot and run slot can be
        had: returns (prompt tokens reused, blocks newly allocated), or
        None with everything it took returned."""
        bs = self.ecfg.block_size
        n_prompt = len(req.prompt)
        # every request pins a run slot: the device token buffer is
        # addressed through it
        if not self._free_slots:
            return None
        adapter_pinned = False
        # match against prompt[:-1]: the last prompt token is always
        # recomputed to produce the first token's logits, so the reuse
        # boundary (KV blocks and the state snapshot, which sit at the
        # same boundary) never covers it
        n_reuse, kv_blocks, state_slot = 0, [], None
        req.hashes = request_block_hashes(req.prompt, bs,
                                          req.adapter_key(), req.salt)
        if self.cache is not None:
            m = self.cache.match_and_acquire(req.prompt[:-1],
                                             req.adapter_key(), req.salt)
            n_reuse, kv_blocks, state_slot = (m.n_tokens, m.kv_blocks,
                                              m.state_slot)
        n_new = (n_prompt + bs - 1) // bs - len(kv_blocks)
        new_blocks: List[int] = []

        def bail() -> None:
            # one cleanup for every failure path: return the matched and
            # freshly allocated blocks, the state-snapshot reference and
            # the adapter-slot pin
            if self.kv_mgr is not None:
                self.kv_mgr.release_all(kv_blocks + new_blocks)
            if state_slot is not None:
                self.st_mgr.release(state_slot)
            if adapter_pinned:
                self.adapter_pool.release(req.adapter_uid)
                req.adapter_slot = 0
            return None

        if self.kv_mgr is not None:
            if self.kv_mgr.num_free() < n_new:
                return bail()
            try:
                for _ in range(n_new):
                    new_blocks.append(self.kv_mgr.allocate())
            except OutOfBlocks:
                return bail()
            req.block_ids = kv_blocks + new_blocks
        # adapter admission charge, after blocks so a block-side failure
        # never pays an eviction+install for nothing
        if req.adapter_uid is not None:
            slot = self.adapter_pool.acquire(req.adapter_uid)
            if slot is None:
                req.block_ids = []
                return bail()
            req.adapter_slot = slot
            adapter_pinned = True

        req.n_computed = n_reuse
        req.n_cache_hit_tokens = n_reuse
        req.run_slot = self._free_slots.pop()
        if self.runner.Ls:
            if state_slot is not None:
                self.runner.restore_state(state_slot, req.run_slot)
                req.state_reused = True
                self.st_mgr.release(state_slot)   # copied into live state
            else:
                self.runner.reset_live(req.run_slot)
        tr = self.tracer
        if tr.enabled:
            tr.ledger_entry(req.req_id, req.adapter_uid, n_reuse,
                            n_prompt - n_reuse, req.state_reused, self.clock)
            t_copy = time.perf_counter()
        # prompt embeddings kept on the host, so each step's assembly
        # packs rows with slice copies (one device→host copy, logged; it
        # waits for the step in flight)
        req.input_embeds = self.runner.build_input_embeds(req.prompt,
                                                          req.prefix_embeds)
        if tr.enabled:
            # the copy moves the prompt's rows as float32
            tr.span("schedule", "admit.embed_copy", t_copy,
                    time.perf_counter(), self.clock,
                    {"req_id": req.req_id,
                     "bytes": 4 * len(req.prompt) * self.cfg.d_model,
                     "step": tr.step})
        if self.cfg.is_encoder_decoder:
            # into the run slot's encoder K/V, which the slot's next
            # admission overwrites: a preempted request is re-encoded
            self.runner.encode(req.frame_embeds, req.run_slot)
        req.state = State.PREFILL
        self.running.append(req)
        return n_reuse, len(new_blocks)

    # ------------------------------------------------------------------
    # adapter-aware admission (EngineConfig.admission_policy="affinity")
    # ------------------------------------------------------------------
    def _affinity_class(self, r: Request) -> int:
        """2 = no install needed (base model or resident adapter), 1 =
        weights staged on the device, 0 = host-only."""
        if r.adapter_uid is None:
            return 2
        return self.adapter_pool.affinity_of(r.adapter_uid)

    def _admit_affinity(self) -> None:
        """Windowed adapter-affinity admission: try the first
        ``admission_window`` waiting requests in affinity order (no
        install first, staged next, host-only last; same adapter
        adjacent), skipping rather than breaking on those that fail.  A
        request bypassed by younger admissions ``admission_starvation_cap``
        times becomes a barrier nothing behind it may pass."""
        ecfg = self.ecfg
        if not self.waiting or len(self.running) >= ecfg.max_running:
            return
        window = list(islice(self.waiting, ecfg.admission_window))
        barrier = len(window) - 1
        for i, r in enumerate(window):
            if r.admission_skips >= ecfg.admission_starvation_cap:
                barrier = i
                break
        candidates = window[:barrier + 1]
        order = sorted(
            range(len(candidates)),
            key=lambda i: (-self._affinity_class(candidates[i]),
                           candidates[i].adapter_uid or "", i))
        admitted: List[int] = []
        for i in order:
            if len(self.running) >= ecfg.max_running:
                break
            r = candidates[i]
            # never issue an acquire that can already be seen failing
            if r.adapter_uid is not None and self._affinity_class(r) < 2 \
                    and not self.adapter_pool.can_take_slot():
                continue
            if self._try_admit(r):
                admitted.append(i)
        if not admitted:
            return
        admitted_ids = {id(candidates[i]) for i in admitted}
        youngest = max(admitted)
        n_skips = 0
        for i, r in enumerate(candidates):
            if i < youngest and id(r) not in admitted_ids:
                r.admission_skips += 1
                n_skips += 1
        if self.tracer.enabled and n_skips:
            self.tracer.count("admission_skips_total", n_skips)
        self.waiting = deque(r for r in self.waiting
                             if id(r) not in admitted_ids)

    # ------------------------------------------------------------------
    # one scheduler step
    # ------------------------------------------------------------------
    def step(self) -> float:
        """Run one engine iteration; returns the step's execution time.

        Schedule (decodes, admission, prefill chunks) → submit (assemble
        and enqueue the mixed step) → retire (fetch the PREVIOUS step's
        sampled ids, patch tokens, hash and register blocks, finish
        requests).  With ``async_submission=False`` the step just
        submitted is retired before returning."""
        while self.pending and self.pending[0].arrival_time <= self.clock:
            self.waiting.append(self.pending.popleft())
        # scheduler-driven adapter prefetch for the admission window;
        # tick() first so expired stages free budget for this step
        if self.adapter_pool is not None:
            self.adapter_pool.tick()
            for r in islice(self.waiting, self.ecfg.admission_window):
                if r.adapter_uid is not None:
                    self.adapter_pool.prefetch(r.adapter_uid)
        if not self.waiting and not self.running:
            if self.pending:
                self.clock = self.pending[0].arrival_time
            return 0.0

        t_before = self.clock
        prev = self._inflight
        self._inflight = None
        tr = self.tracer
        if tr.enabled:
            tr.step += 1
        t_sched0 = time.perf_counter()

        # ---- schedule ------------------------------------------------
        # decode first: running requests claim their next block before
        # admission can hand freed blocks to new requests
        decodes = self._schedule_decodes()
        n_decode = len(decodes)
        if self.ecfg.admission_policy == "fcfs":
            while self.waiting \
                    and len(self.running) < self.ecfg.max_running:
                if not self._try_admit(self.waiting[0]):
                    break
                self.waiting.popleft()
        else:
            self._admit_affinity()
        # chunked-prefill budget: what the decodes left of
        # max_batched_tokens, minus last step's minimum-progress
        # overdraft; only a decode-free step may overdraw by one block
        budget = self.ecfg.max_batched_tokens - n_decode - self._budget_debt
        if n_decode == 0 and budget < self.ecfg.block_size:
            budget = self.ecfg.block_size
        prefills = self._schedule_prefills(budget)
        n_prefill = sum(hi - lo for _, lo, hi in prefills)
        self._budget_debt = max(0, n_decode + n_prefill + self._budget_debt
                                - self.ecfg.max_batched_tokens)
        self.last_step_tokens = (n_decode, n_prefill)
        if tr.enabled:
            tr.span("schedule", "schedule", t_sched0, time.perf_counter(),
                    self.clock,
                    {"n_decode": n_decode, "n_prefill": n_prefill,
                     "running": len(self.running),
                     "waiting": len(self.waiting)})
            tr.count("steps_total")
            tr.count("decode_tokens_total", n_decode)
            tr.count("prefill_tokens_total", n_prefill)

        # ---- submit --------------------------------------------------
        if self.use_mixed:
            t_sub0 = time.perf_counter()
            asm0 = self.t_assembly + self.runner.t_assembly
            inflight = self._submit_mixed(decodes, prefills)
            if tr.enabled and inflight is not None:
                tr.span("submit", "submit", t_sub0, time.perf_counter(),
                        self.clock,
                        {"n_decode": n_decode, "n_prefill": n_prefill,
                         "t_assembly": self.t_assembly
                         + self.runner.t_assembly - asm0})
            if inflight is not None and prev is not None:
                self.async_overlap_steps += 1
            if not self.use_async and inflight is not None:
                self._retire_traced(inflight)
                inflight = None
            # ---- retire (async: AFTER step N+1 is in flight) --------
            self._retire_traced(prev)
            self._inflight = inflight
        else:
            # sequential: every call below runs to completion, so each
            # token value is host-known when its bookkeeping runs
            self._execute_decodes(decodes)
            self._execute_prefills(prefills)
            # phase: retire-ok (sequential oracle path)
            self._finish_requests()
        # block starvation with zero progress and the pipeline drained:
        # preempt the most recent running request (recompute-preemption)
        if n_decode == 0 and n_prefill == 0 and prev is None \
                and self.running:
            # drain-guarded: prev is None means no unretired step is in
            # flight, so no PENDING value can race the rollback
            # phase: retire-ok (pipeline drained)
            self._preempt(self.running[-1])
        return self.clock - t_before

    # ------------------------------------------------------------------
    def _preempt(self, r: Request) -> None:
        # bumping the epoch makes the retire phase drop any rows of r
        # still riding an unretired step
        r.epoch += 1
        while r.output_tokens and r.output_tokens[-1] == PENDING:
            r.output_tokens.pop()
        if self.kv_mgr is not None and r.block_ids:
            self.kv_mgr.release_all(r.block_ids)
        r.block_ids = []
        if r.run_slot >= 0:
            self._free_slots.append(r.run_slot)
            r.run_slot = -1
        if r.adapter_uid is not None and r.adapter_slot > 0:
            self.adapter_pool.release(r.adapter_uid)
            r.adapter_slot = 0
        r.n_computed = 0
        r.state_reused = False
        r.state = State.QUEUED
        self.running.remove(r)
        self.waiting.appendleft(r)
        self.preemptions += 1
        if self.tracer.enabled:
            self.tracer.event("schedule", "preempt", self.clock,
                              {"req_id": r.req_id})
            self.tracer.count("preemptions_total")
        if self.preemptions > 1000:
            raise RuntimeError("preemption livelock: pool too small for "
                               "a single request")

    # ------------------------------------------------------------------
    # scheduling: pick this step's work (and claim blocks)
    # ------------------------------------------------------------------
    def _schedule_decodes(self) -> List[Request]:
        # requests whose final token still rides an unretired step take
        # no further decode row
        decodes = [r for r in self.running
                   if r.state == State.DECODE and not r.is_finished()]
        bs = self.ecfg.block_size
        ok: List[Request] = []
        for r in decodes:
            pos = r.n_computed
            if self.kv_mgr is not None:
                n_before = len(r.block_ids)
                while len(r.block_ids) <= pos // bs:
                    try:
                        r.block_ids.append(self.kv_mgr.allocate())
                    except OutOfBlocks:
                        break
                if len(r.block_ids) <= pos // bs:
                    # starved: return the partial claim; retry next step
                    while len(r.block_ids) > n_before:
                        self.kv_mgr.release(r.block_ids.pop())
                    continue
            ok.append(r)
        return ok

    def _schedule_prefills(self, budget: int
                           ) -> List[Tuple[Request, int, int]]:
        bs = self.ecfg.block_size
        spans: List[Tuple[Request, int, int]] = []
        for r in self.running:
            if budget <= 0:
                break
            if r.state != State.PREFILL:
                continue
            n_prompt = len(r.prompt)
            lo = r.n_computed
            hi = min(n_prompt, lo + min(budget,
                                        self.runner.rcfg.chunk_tokens))
            # chunk boundaries stay block-aligned except the final chunk
            if hi < n_prompt:
                hi = lo + ((hi - lo) // bs) * bs
                if hi <= lo:
                    continue
            if r.t_prefill_start is None:
                r.t_prefill_start = self.clock
            budget -= hi - lo
            spans.append((r, lo, hi))
        return spans

    # ------------------------------------------------------------------
    # token-value-free bookkeeping (submit time) and its deferred half
    # ------------------------------------------------------------------
    def _advance_decode(self, r: Request
                        ) -> Tuple[Optional[int], Optional[int],
                                   Optional[int]]:
        """Advance ``r`` past one decode token whose value may still be on
        the device.  Returns ``(patch_idx, boundary_pos, snap_slot)`` for
        retire: the output_tokens index holding a PENDING placeholder
        (frontier rows only), the position that completed a block, and
        the state-snapshot slot claimed for it.  The live state is
        snapshotted NOW, while the pools hold this step's output: the
        copy is enqueued after the step and before the next one."""
        r.n_computed += 1
        bs = self.ecfg.block_size
        pos = r.n_computed
        boundary_pos = snap_slot = None
        if self.cache is not None and pos % bs == 0:
            boundary_pos = pos
            if self.st_mgr is not None:
                b = pos // bs - 1
                # with every token of block b host-known (the sync path),
                # the hash is computable now: skip the claim and the
                # copies for a state the cache already holds.  Async must
                # not: the entry could be evicted before this step
                # retires, and by then the live pool has moved on.
                known = all(t != PENDING
                            for t in r.all_tokens[len(r.hashes) * bs:pos])
                cached = False
                if known and not self.use_async:
                    # phase: retire-ok (sync path, tokens host-known)
                    self._extend_hash_chain(r, b)
                    cached = self.st_mgr.lookup(r.hashes[b]) is not None
                if not cached:
                    try:
                        snap_slot = self.st_mgr.allocate()
                    except OutOfBlocks:
                        snap_slot = None      # pool pressure: skip it
                    else:
                        self.runner.snapshot_live(max(r.run_slot, 0),
                                                  snap_slot)
        patch_idx = None
        # extend only at the sampling frontier (after a preemption the
        # decode path recomputes known tokens first)
        if pos == len(r.all_tokens) and not r.is_finished():
            patch_idx = len(r.output_tokens)
            r.output_tokens.append(PENDING)
        return patch_idx, boundary_pos, snap_slot

    def _advance_prefill(self, r: Request, lo: int, hi: int,
                         boundary) -> Optional[int]:
        """Register the blocks this chunk completed (prompt hashes are
        known since admission) with their state snapshots from
        ``boundary`` (this chunk's slice of the step's boundary states)
        and, when the prompt is done, leave the first token's PENDING
        placeholder; returns its index or None."""
        r.n_computed = hi
        self._register_prefill_blocks(r, lo, hi, boundary)
        patch_idx = None
        if hi == len(r.prompt):
            r.state = State.DECODE
            if not r.output_tokens:                 # not a re-prefill
                patch_idx = 0
                r.output_tokens.append(PENDING)
        return patch_idx

    def _postprocess_decode(self, r: Request, tok: int) -> None:
        """Sequential decode bookkeeping: advance and retire back to back
        with the host-known token."""
        patch_idx, boundary_pos, snap_slot = self._advance_decode(r)
        if patch_idx is not None:
            r.output_tokens[patch_idx] = tok
        if boundary_pos is not None:
            self._register_decode_block(r, boundary_pos, snap_slot)

    def _postprocess_prefill(self, r: Request, lo: int, hi: int,
                             logits_row: np.ndarray, boundary) -> None:
        patch_idx = self._advance_prefill(r, lo, hi, boundary)
        if r.state == State.DECODE and r.t_decode_start is None:
            r.t_decode_start = self.clock
        if patch_idx is not None:
            r.output_tokens[patch_idx] = int(np.argmax(logits_row))
            if patch_idx == 0 and self.tracer.enabled \
                    and r.t_first_token_wall is None:
                r.t_first_token_wall = time.perf_counter()

    def _adapter_idx(self, r: Request, positions: np.ndarray) -> np.ndarray:
        return adapter_index_for_positions(
            positions, r.adapter_slot,
            r.adapter.kind if r.adapter else None, r.inv_start)

    # ------------------------------------------------------------------
    # sequential execution: one decode batch and one call per prefill
    # chunk, each synchronous (the mixed path's equivalence oracle)
    # ------------------------------------------------------------------
    def _execute_decodes(self, ok: List[Request]) -> None:
        if not ok:
            return
        positions = np.array([r.n_computed for r in ok], np.int32)
        t0 = time.perf_counter()
        logits = self.runner.decode_batch(
            tokens=np.array([r.all_tokens[r.n_computed] for r in ok],
                            np.int32),
            positions=positions, lengths=positions + 1,
            block_tables=[r.block_ids for r in ok],
            adapter_idx=np.array([self._adapter_idx(r, positions[i:i + 1])[0]
                                  for i, r in enumerate(ok)], np.int32),
            run_slots=np.array([max(r.run_slot, 0) for r in ok], np.int32))
        self._advance_clock(t0)
        for r, t in zip(ok, np.argmax(logits, axis=-1)):
            self._postprocess_decode(r, int(t))

    def _execute_prefills(self, spans: List[Tuple[Request, int, int]]
                          ) -> None:
        for r, lo, hi in spans:
            t0 = time.perf_counter()
            logits, boundary = self.runner.prefill_chunk(
                input_embeds=r.input_embeds, lo=lo, hi=hi,
                block_ids=r.block_ids if self.kv_mgr is not None else [],
                adapter_idx_row=self._adapter_idx(r, np.arange(lo, hi)),
                run_slot=max(r.run_slot, 0))
            logits = logits.float().cpu().numpy()
            self._advance_clock(t0)
            self._postprocess_prefill(r, lo, hi, logits, boundary)

    # ------------------------------------------------------------------
    # mixed-batch execution: every decode token and prefill chunk of the
    # step packed into one ragged batch → one mixed step on the device
    # ------------------------------------------------------------------
    def _submit_mixed(self, decodes: List[Request],
                      prefills: List[Tuple[Request, int, int]]
                      ) -> Optional[_InflightStep]:
        if not decodes and not prefills:
            return None
        t_host = time.perf_counter()
        bs = self.ecfg.block_size
        reqs = decodes + [r for r, _, _ in prefills]
        R = len(reqs)
        T = len(decodes) + sum(hi - lo for _, lo, hi in prefills)
        take = self.runner.host_bufs.take
        tok_ids = take("e_tok", T, np.int32)
        embeds = take("e_emb", T, np.float32, trailing=(self.cfg.d_model,))
        use_embeds = take("e_use", T, bool)
        from_buf = take("e_fb", T, bool)
        positions = take("e_pos", T, np.int32)
        adapter_idx = take("e_ad", T, np.int32)
        req_rows = take("e_rows", T, np.int32)
        row_cols = take("e_cols", T, np.int32)
        write_bids = take("e_wb", T, np.int32)
        write_offs = take("e_wo", T, np.int32)
        out_rows = take("e_out", R, np.int32)
        run_slots = take("e_slots", R, np.int32)
        block_tables = [list(r.block_ids) for r in reqs]
        # packed indices of prefill block-boundary tokens (SSM snapshot
        # emission points) and each span's (offset, count) into them
        snap_rows: List[int] = []
        span_snaps: List[Tuple[int, int]] = []

        t = 0
        for i, r in enumerate(decodes):
            pos = r.n_computed
            tok = r.all_tokens[pos]
            # PENDING: last step's sample, not yet on the host — the
            # device reads it from tok_buf at this request's run slot
            from_buf[t] = tok == PENDING
            tok_ids[t] = max(tok, 0)
            positions[t] = pos
            adapter_idx[t] = self._adapter_idx(r, np.array([pos]))[0]
            req_rows[t] = i
            if self.kv_mgr is not None:
                write_bids[t] = r.block_ids[pos // bs]
                write_offs[t] = pos % bs
            out_rows[i] = t
            run_slots[i] = max(r.run_slot, 0)
            t += 1
        for j, (r, lo, hi) in enumerate(prefills):
            row = len(decodes) + j
            n = hi - lo
            sl = slice(t, t + n)
            pr = np.arange(lo, hi)
            embeds[sl] = r.input_embeds[lo:hi]
            use_embeds[sl] = True
            positions[sl] = pr
            adapter_idx[sl] = self._adapter_idx(r, pr)
            req_rows[sl] = row
            row_cols[sl] = pr - lo
            if self.kv_mgr is not None:
                bids = np.array(r.block_ids, np.int32)
                write_bids[sl] = bids[pr // bs]
                write_offs[sl] = pr % bs
            out_rows[row] = t + n - 1
            run_slots[row] = max(r.run_slot, 0)
            off = len(snap_rows)
            if self.st_mgr is not None:
                # every b in [lo // bs, hi // bs) is a full block
                for b in range(lo // bs, hi // bs):
                    snap_rows.append(t + (b + 1) * bs - 1 - lo)
            span_snaps.append((off, len(snap_rows) - off))
            t += n

        # the step's active adapter slots, ascending: every token's
        # adapter index is 0 or its request's pinned slot
        active = sorted({r.adapter_slot for r in reqs
                         if r.adapter_slot > 0})
        mb = MixedBatch(tok_ids=tok_ids, embeds=embeds,
                        use_embeds=use_embeds, from_buf=from_buf,
                        positions=positions, adapter_idx=adapter_idx,
                        req_rows=req_rows, row_cols=row_cols,
                        write_bids=write_bids, write_offs=write_offs,
                        block_tables=block_tables, out_rows=out_rows,
                        run_slots=run_slots,
                        snap_rows=np.array(snap_rows, np.int32),
                        active_slots=np.array(active, np.int32))
        t1 = time.perf_counter()
        self.t_assembly += t1 - t_host
        tr = self.tracer
        if tr.enabled:
            tr.span("submit", "submit.pack", t_host, t1, self.clock,
                    {"T": T, "R": R, "step": tr.step})
        t0 = time.perf_counter()
        handle = self.runner.submit_batch(mb)   # enqueued, not awaited
        self._advance_clock(t0)
        # decode rows first, then prefill — the reference's order
        retires: List[Tuple] = []
        for i, r in enumerate(decodes):
            patch_idx, bpos, slot = self._advance_decode(r)
            retires.append((r, r.epoch, i, patch_idx, bpos, slot))
        for j, (r, lo, hi) in enumerate(prefills):
            bnd = None
            if handle.boundary is not None:
                off, cnt = span_snaps[j]
                bnd = (handle.boundary[0][:, off:off + cnt],
                       handle.boundary[1][:, off:off + cnt])
            patch_idx = self._advance_prefill(r, lo, hi, bnd)
            retires.append((r, r.epoch, len(decodes) + j, patch_idx, None,
                            None))
        return _InflightStep(handle=handle, retires=retires)

    # ------------------------------------------------------------------
    def _retire_traced(self, inf: Optional[_InflightStep]) -> None:
        if inf is None:
            return
        t0 = time.perf_counter()
        self._retire(inf)
        if self.tracer.enabled:
            self.tracer.span("retire", "retire", t0, time.perf_counter(),
                             self.clock, {"rows": len(inf.retires)})

    def _retire(self, inf: _InflightStep) -> None:
        """The one blocking device→host sync per iteration (the sampled
        ids), then the deferred bookkeeping.  Rows whose request was
        preempted after submit (epoch mismatch) are dropped; only their
        state-snapshot claim needs returning."""
        t0 = time.perf_counter()
        sampled = self.runner.fetch_sampled(inf.handle)
        self._advance_clock(t0)
        tr = self.tracer
        if tr.enabled:
            # the sampled ids are on the host from here: the first token
            # of a request whose prefill ended in this step arrives now
            t_book = time.perf_counter()
        for r, epoch, row, patch_idx, bpos, slot in inf.retires:
            if r.epoch != epoch:
                if slot is not None:
                    self.st_mgr.release(slot)
                continue
            # first-token arrival defines decode start (TTFT includes the
            # prefill step's device time)
            if r.state == State.DECODE and r.t_decode_start is None:
                r.t_decode_start = self.clock
            if patch_idx is not None:
                r.output_tokens[patch_idx] = int(sampled[row])
                if patch_idx == 0 and tr.enabled \
                        and r.t_first_token_wall is None:
                    r.t_first_token_wall = t_book
            if bpos is not None:
                self._register_decode_block(r, bpos, slot)
        self._finish_requests()
        if tr.enabled:
            tr.span("retire", "retire.book", t_book, time.perf_counter(),
                    self.clock, {"rows": len(inf.retires),
                                 "step": inf.handle.step})

    # ------------------------------------------------------------------
    def _adopt_canonical(self, r: Request, b: int, h) -> None:
        """Register block ``b`` of ``r`` under ``h``; when another live
        block already owns the hash, remap onto it and release ours."""
        bid = r.block_ids[b]
        canon = self.cache.register_kv_block(h, bid)
        if canon != bid:
            self.kv_mgr.acquire(canon)
            self.kv_mgr.release(bid)
            r.block_ids[b] = canon

    def _register_prefill_blocks(self, r: Request, lo: int, hi: int,
                                 boundary) -> None:
        if self.cache is None:
            return
        bs = self.ecfg.block_size
        for b in range(lo // bs, hi // bs):
            if (b + 1) * bs > hi:
                break
            h = r.hashes[b]
            if self.kv_mgr is not None and b < len(r.block_ids):
                self._adopt_canonical(r, b, h)
            if self.st_mgr is not None and self.st_mgr.lookup(h) is None:
                try:
                    slot = self.st_mgr.allocate()
                except OutOfBlocks:
                    continue
                # boundary row c of this chunk is block lo // bs + c
                self.runner.snapshot_boundary(boundary, b - lo // bs, slot)
                self.cache.register_state(h, slot)
                self.st_mgr.release(slot)       # cached, not owned

    def _extend_hash_chain(self, r: Request, b: int) -> None:
        """Extend the block-hash chain incrementally through block ``b``;
        every token through block ``b`` must be host-known."""
        bs = self.ecfg.block_size
        toks = r.all_tokens
        while len(r.hashes) <= b:
            i = len(r.hashes)
            lo, hi = i * bs, (i + 1) * bs
            parent = r.hashes[-1] if r.hashes else None
            extra = r.salt + block_extra(r.adapter_key(), lo, hi)
            r.hashes.append(hash_block(parent, toks[lo:hi], extra))

    def _register_decode_block(self, r: Request, pos: int,
                               snap_slot: Optional[int]) -> None:
        """A decode step that reached ``pos`` completed a block: hash and
        register it (generated tokens are cached too, paper §4.4), with
        the live-state snapshot ``_advance_decode`` took into
        ``snap_slot``.  Runs at retire, when the block's token values are
        host-known."""
        b = pos // self.ecfg.block_size - 1
        self._extend_hash_chain(r, b)
        h = r.hashes[b]
        if self.kv_mgr is not None and b < len(r.block_ids):
            self._adopt_canonical(r, b, h)
        if snap_slot is not None:
            if self.st_mgr.lookup(h) is None:
                self.cache.register_state(h, snap_slot)
            self.st_mgr.release(snap_slot)

    def _finish_requests(self) -> None:
        still = []
        for r in self.running:
            # finish only once the final token VALUE is on the host
            if r.state == State.DECODE and r.is_finished() \
                    and (not r.output_tokens
                         or r.output_tokens[-1] != PENDING):
                r.state = State.DONE
                r.t_done = self.clock
                if self.tracer.enabled:
                    r.t_done_wall = time.perf_counter()
                    self.tracer.request_summary(
                        r.req_id, r.adapter_uid, r.arrival_time,
                        r.t_prefill_start, r.t_decode_start, r.t_done,
                        len(r.prompt), len(r.output_tokens),
                        r.n_cache_hit_tokens,
                        wall={"t_submit_wall": r.t_submit_wall,
                              "t_admit_wall": r.t_admit_wall,
                              "t_first_token_wall": r.t_first_token_wall,
                              "t_done_wall": r.t_done_wall})
                if self.kv_mgr is not None:
                    self.kv_mgr.release_all(r.block_ids)
                if r.run_slot >= 0:
                    self._free_slots.append(r.run_slot)
                if r.adapter_uid is not None and r.adapter_slot > 0:
                    self.adapter_pool.release(r.adapter_uid)
                    r.adapter_slot = 0
                self.done.append(r)
            else:
                still.append(r)
        self.running = still

    # ------------------------------------------------------------------
    def run_until_idle(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if not (self.pending or self.waiting or self.running):
                return
            self.step()
        raise RuntimeError("engine did not drain")

    def metrics_for(self, req_ids: Sequence[int]) -> MetricsAggregate:
        ids = set(req_ids)
        return aggregate([r.metrics() for r in self.done
                          if r.req_id in ids])

    def request(self, req_id: int) -> Request:
        for pool in (self.done, self.running, self.waiting, self.pending):
            for r in pool:
                if r.req_id == req_id:
                    return r
        raise KeyError(req_id)

    def kv_hit_rate(self) -> float:
        mgr = self.kv_mgr or self.st_mgr
        return mgr.hit_rate()

    # ------------------------------------------------------------------
    # replica surface (serving/router.py): read-only placement probes,
    # host-side Python over scheduler state — no device work, no
    # refcount, hit or miss counter touched
    # ------------------------------------------------------------------
    @property
    def idle(self) -> bool:
        """No live work anywhere in the pipeline (queued or admitted).
        A request stays in ``running`` until the step carrying its last
        token retires, so an async step in flight keeps this False."""
        return not (self.pending or self.waiting or self.running)

    def cached_prefix_tokens(self, prompt: Sequence[int],
                             adapter_name: Optional[str] = None,
                             salt: Tuple = ()) -> int:
        """How many leading prompt tokens this replica's prefix cache
        could serve, were the request admitted here: the chained
        base-aligned block hashes admission matches on, walked with
        non-acquiring lookups."""
        if self.cache is None:
            return 0
        prompt = list(map(int, prompt))
        key: Optional[AdapterKey] = None
        if adapter_name is not None:
            pool = self.adapter_pool
            if pool is None:
                raise KeyError(adapter_name)
            uid = pool.uid_of(adapter_name)
            spec = pool.get(uid).spec
            inv = _activation_start(prompt, spec) \
                if spec.kind == "alora" else 0
            key = AdapterKey(uid, spec.kind, inv)
        # as at admission, the last prompt token is always recomputed
        return self.cache.probe(prompt[:-1], key, salt)

    def outstanding_tokens(self) -> int:
        """Uncomputed prompt plus ungenerated output over every queued
        and admitted request: the router's least-loaded tiebreak."""
        n = 0
        for r in self.pending:
            n += len(r.prompt) + r.max_new_tokens
        for r in self.waiting:
            n += len(r.prompt) + r.max_new_tokens
        for r in self.running:
            n += max(len(r.prompt) - r.n_computed, 0)
            n += max(r.max_new_tokens - len(r.output_tokens), 0)
        return n

    def adapter_residency(self) -> Dict[str, bool]:
        """Adapter name → installed in a device slot."""
        pool = self.adapter_pool
        return {} if pool is None else pool.residency()

    def adapter_affinity(self, name: str) -> int:
        """2 slot-resident, 1 staged on the device, 0 host-only or
        unknown: the graded residency the router scores with."""
        pool = self.adapter_pool
        return 0 if pool is None else pool.affinity(name)
