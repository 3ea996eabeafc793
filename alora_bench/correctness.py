"""The check that decides ``correct``: the tokens the timed path served,
judged by the plain reference.

Once the window has closed, a sample drawn from the seed of the requests
due in the window that finished, with the longest among them and the
adapted request that the cache served most (on an SSM model, one whose
state snapshot was restored), is scored by the reference of the
configuration's model family: one teacher-forced pass over each prompt
and the tokens served after it.  At each served token the reading is how
far its logit lies below the reference's best logit there; the number
compared is the widest such gap over the sample (``max_logit_gap``).
The control takes the program's place: at the same positions, the tokens
that the reference computed one precision below the configuration's puts
first are judged instead of the served ones, by the same number and the
same limit (the served tokens' gap is then kept as
``served_logit_gap``)."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from alora_bench import draws
from alora_bench.reference import Seq, find_last


def sample(requests: Sequence, seed: int, target_tokens: int,
           max_requests: int) -> List:
    """Finished requests to score: the longest, the adapted one with the
    most reused prompt tokens (a restored state first), then a seeded
    draw until ``target_tokens`` served tokens or ``max_requests``."""
    done = [t for t in requests if t.t_done is not None and t.outputs()]
    if not done:
        return []
    done.sort(key=lambda t: t.rid)
    picked = [max(done, key=lambda t: t.prompt_len + len(t.outputs()))]
    adapted = [t for t in done if t.turn.adapter is not None]
    if adapted:
        best = max(adapted, key=lambda t: (bool(t.req.state_reused),
                                           t.req.n_cache_hit_tokens))
        if best is not picked[0]:
            picked.append(best)
    rng = draws.make_rng(seed, "correctness.sample")
    served = sum(len(t.outputs()) for t in picked)
    for i in rng.permutation(len(done)):
        if served >= target_tokens or len(picked) >= max_requests:
            break
        t = done[int(i)]
        if any(t is p for p in picked):
            continue
        picked.append(t)
        served += len(t.outputs())
    return picked


def sequences(picked: Sequence, invocations: Sequence[Sequence[int]]
              ) -> List[Seq]:
    out = []
    for t in picked:
        prompt, outs = list(t.turn.prompt), t.outputs()
        a = t.turn.adapter
        inv = len(prompt)
        if a is not None:
            found = find_last(prompt, invocations[a])
            inv = len(prompt) if found is None else found
        out.append(Seq(tokens=prompt + outs[:-1], adapter=a, inv_start=inv,
                       want=list(range(len(prompt) - 1,
                                       len(prompt) - 1 + len(outs)))))
    return out


def gaps_of(ref: torch.Tensor, tokens: Sequence[int]) -> np.ndarray:
    """How far each token's logit lies below the row's best."""
    idx = torch.tensor(list(tokens), device=ref.device)
    best = ref.max(dim=-1).values
    return (best - ref.gather(1, idx[:, None])[:, 0]).cpu().numpy()


CONTROL = {"bfloat16": "fp8", "float32": "bf16"}   # one precision below


def judge(family, dims: Dict[str, Any], weights: Dict[str, Any], adapters,
          invocations, picked: Sequence, device, control: bool = False
          ) -> Dict[str, Any]:
    """Readings of the sample, by the reference of the cell's model
    ``family``: the widest gap of the served tokens; with ``control``,
    that of the tokens the reference puts first when computed one
    precision below the configuration's (float8 for bfloat16, bfloat16
    for the tests' float32), judged in their place."""
    seqs = sequences(picked, invocations)
    V = dims["vocab_size"]
    ref = family.reference(dims, weights, adapters, device).logits(seqs)
    served = [t.outputs() for t in picked]
    g = np.concatenate([gaps_of(r, s) for r, s in zip(ref, served)])
    out = {"max_logit_gap": float(g.max()), "tokens": int(g.size),
           "requests": len(picked),
           "flipped": int(np.count_nonzero(g > 0)),
           "adapted": sum(1 for t in picked if t.turn.adapter is not None),
           "reused_tokens": int(sum(t.reused for t in picked)),
           "restored": sum(1 for t in picked if t.restored)}
    if control:
        low = family.reference(dims, weights, adapters, device,
                               quant=CONTROL[dims["dtype"]]).logits(seqs)
        cg = np.concatenate([
            gaps_of(r, torch.argmax(c[:, :V], dim=-1).tolist())
            for r, c in zip(ref, low)])
        out["served_logit_gap"] = out["max_logit_gap"]
        out["max_logit_gap"] = float(cg.max())
        out["flipped"] = int(np.count_nonzero(cg > 0))
    return out


def verdict(readings: Dict[str, Any], limits: Dict[str, float]
            ) -> Optional[Dict[str, Dict[str, float]]]:
    """Each compared number beside its limit, or None without a sample."""
    if not readings.get("tokens"):
        return None
    return {name: {"value": readings[name], "limit": float(limit)}
            for name, limit in limits.items() if name in readings}
