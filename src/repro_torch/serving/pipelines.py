"""Multi-turn, multi-adapter pipelines (paper §4.1), a copy of the
reference's ``repro/serving/pipelines.py``.

The atomic pattern: query base model M1 with prompt x → response y;
query adapter A1 with (x+y) → evaluation r; optionally feed (x+y+r) back
into M1.  Baseline = the same pipeline with vanilla-LoRA adapters (no
cross-model cache reuse); ours = aLoRA adapters.

Each pipeline returns per-stage request ids so that callers aggregate
stage metrics as the paper does (evaluation-step metrics are the
headline numbers).  The pipelines take an ``Engine`` or a ``Router``
(the same submit / run_until_idle / request / metrics_for surface).
The same seed draws the same prompts as the reference (numpy
``RandomState``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.serving.engine import Engine
from repro_torch.serving.metrics import MetricsAggregate


@dataclass
class PipelineResult:
    base_ids: List[int] = field(default_factory=list)
    eval_ids: List[int] = field(default_factory=list)   # adapter step
    final_ids: List[int] = field(default_factory=list)  # second base call

    def stage_metrics(self, eng: Engine, stage: str) -> MetricsAggregate:
        ids = {"base": self.base_ids, "eval": self.eval_ids,
               "final": self.final_ids}[stage]
        return eng.metrics_for(ids)


def _rand_prompt(rng: np.random.RandomState, n: int, vocab: int,
                 lo: int = 10) -> List[int]:
    return list(rng.randint(lo, vocab, n))


def base_adapter(eng: Engine, *, adapter_names: Sequence[str],
                 prompt_len: int, gen_len: int, eval_len: int,
                 batch: int = 1, seed: int = 0,
                 feed_back_to_base: bool = False,
                 final_len: int = 16) -> PipelineResult:
    """Sync base → adapter (→ base) pipeline, ``batch`` parallel
    instances.  With several adapter names the adapters are invoked in
    parallel on the same (x + y) context (paper §4.4.1); with
    ``feed_back_to_base`` the base model then takes x + y + every
    adapter's output (the ``final`` stage, ``final_len`` tokens)."""
    rng = np.random.RandomState(seed)
    vocab = eng.cfg.vocab_size
    res = PipelineResult()
    prompts = [_rand_prompt(rng, prompt_len, vocab) for _ in range(batch)]

    for x in prompts:
        res.base_ids.append(eng.submit(x, gen_len))
    eng.run_until_idle()

    for rid, x in zip(res.base_ids, prompts):
        y = eng.request(rid).output_tokens
        for name in adapter_names:
            inv = list(eng.adapters[name].spec.invocation_tokens or ())
            res.eval_ids.append(eng.submit(x + y + inv, eval_len,
                                           adapter_name=name))
    eng.run_until_idle()

    if feed_back_to_base:
        k = len(adapter_names)
        for bi, (rid, x) in enumerate(zip(res.base_ids, prompts)):
            ctx = x + eng.request(rid).output_tokens
            for eid in res.eval_ids[bi * k:(bi + 1) * k]:
                ctx = ctx + eng.request(eid).output_tokens
            res.final_ids.append(eng.submit(ctx, final_len))
        eng.run_until_idle()
    return res


def adapter_base(eng: Engine, *, adapter_name: str, prompt_len: int,
                 eval_len: int, gen_len: int, batch: int = 1,
                 seed: int = 0) -> PipelineResult:
    """Sync adapter → base pipeline (paper App. C): an adapter screens the
    prompt, then the base model generates; the base reuses the adapter's
    pre-activation prefill blocks (two-way reuse)."""
    rng = np.random.RandomState(seed)
    vocab = eng.cfg.vocab_size
    res = PipelineResult()
    inv = list(eng.adapters[adapter_name].spec.invocation_tokens or ())
    prompts = [_rand_prompt(rng, prompt_len, vocab) for _ in range(batch)]

    for x in prompts:
        res.eval_ids.append(
            eng.submit(x + inv, eval_len, adapter_name=adapter_name))
    eng.run_until_idle()

    for rid, x in zip(res.eval_ids, prompts):
        r = eng.request(rid).output_tokens
        res.final_ids.append(eng.submit(x + r, gen_len))
    eng.run_until_idle()
    return res


def async_base_adapter(eng: Engine, *, adapter_name: str,
                       arrival_rate: float, num_requests: int,
                       prompt_len: int, gen_len: int, eval_len: int,
                       seed: int = 0) -> PipelineResult:
    """Async base → adapter pipeline: pipeline instances arrive as a
    Poisson process with rate ``arrival_rate`` (paper §4.3).  The adapter
    request is submitted the moment its base request completes."""
    rng = np.random.RandomState(seed)
    vocab = eng.cfg.vocab_size
    inv = list(eng.adapters[adapter_name].spec.invocation_tokens or ())
    arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, num_requests))
    res = PipelineResult()
    prompts: Dict[int, List[int]] = {}
    for t in arrivals:
        x = _rand_prompt(rng, prompt_len, vocab)
        rid = eng.submit(x, gen_len, arrival_time=float(t))
        prompts[rid] = x
        res.base_ids.append(rid)

    submitted = set()
    for _ in range(10_000_000):
        if not (eng.pending or eng.waiting or eng.running) \
                and len(submitted) == len(res.base_ids):
            break
        eng.step()
        for rid in res.base_ids:
            if rid in submitted:
                continue
            req = eng.request(rid)
            if req.t_done is not None:
                p = prompts[rid] + req.output_tokens + inv
                res.eval_ids.append(
                    eng.submit(p, eval_len, adapter_name=adapter_name,
                               arrival_time=req.t_done))
                submitted.add(rid)
    eng.run_until_idle()
    return res
