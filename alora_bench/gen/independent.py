"""Independent requests arriving as a Poisson process: short chat and
classification calls.  The share ``adapter_share`` of them go to one of
the adapters, with its invocation tokens at the prompt's end; no
request shares a prefix with an earlier one.

Parameters (the mix file): ``prompt`` {median, sigma, min, max} (the
invocation tokens included), ``output`` [lo, hi], ``adapter_share``.
Token ids and lengths only."""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

from alora_bench import draws
from alora_bench.draws import Turn


class Single:
    def __init__(self, turn: Turn):
        self.turn = turn

    def first(self) -> Turn:
        return self.turn

    def follow(self, prompt: List[int], output: List[int]) -> Optional[Turn]:
        return None


def make(params: dict, *, seed: int, rate: float, vocab: Tuple[int, int],
         invocations: Sequence[Sequence[int]]
         ) -> Iterator[Tuple[float, Single]]:
    sizes = draws.make_rng(seed, "independent.sizes")
    ids = draws.make_rng(seed, "independent.ids")
    n, t = draws.BLOCK, 0.0
    while True:
        gaps = draws.exponential_gaps(rate, n, sizes)
        plen = draws.lognormal_ints(params["prompt"], n, sizes)
        out = draws.uniform_ints(params["output"], n, sizes)
        adapted = draws.shares(params["adapter_share"], n, sizes)
        adapter = draws.spread(n, len(invocations), sizes)
        for i in range(n):
            t += float(gaps[i])
            if adapted[i]:
                a = int(adapter[i])
                inv = list(invocations[a])
                prompt = draws.token_ids(int(plen[i]) - len(inv), vocab,
                                         ids) + inv
                yield t, Single(Turn(prompt, int(out[i]), a, "chat"))
            else:
                yield t, Single(Turn(draws.token_ids(int(plen[i]), vocab,
                                                     ids),
                                     int(out[i]), None, "chat"))
