"""The paper's base → adapter pipeline (§4.1), ported from the
reference's ``repro/serving/pipelines.py::base_adapter``.

Query the base model with prompt x → response y; query each adapter
with (x + y + invocation tokens) → evaluation r.  With aLoRA adapters the
evaluation requests reuse the base request's prefix blocks.  The same
seed draws the same prompts as the reference (numpy ``RandomState``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np

from repro_torch.serving.engine import Engine
from repro_torch.serving.metrics import MetricsAggregate


@dataclass
class PipelineResult:
    base_ids: List[int] = field(default_factory=list)
    eval_ids: List[int] = field(default_factory=list)   # adapter step

    def stage_metrics(self, eng: Engine, stage: str) -> MetricsAggregate:
        ids = {"base": self.base_ids, "eval": self.eval_ids}[stage]
        return eng.metrics_for(ids)


def base_adapter(eng: Engine, *, adapter_names: Sequence[str],
                 prompt_len: int, gen_len: int, eval_len: int,
                 batch: int = 1, seed: int = 0) -> PipelineResult:
    """Synchronous base → adapter pipeline, ``batch`` parallel instances;
    with several adapter names they run in parallel on the same (x + y)
    context (paper §4.4.1)."""
    rng = np.random.RandomState(seed)
    vocab = eng.cfg.vocab_size
    res = PipelineResult()
    prompts = [list(rng.randint(10, vocab, prompt_len))
               for _ in range(batch)]
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
    return res
