"""Open-loop RAG sessions (the paper's §4.1 pipelines at deployment
lengths).  Sessions arrive as a Poisson process.  Each sends a base
request (documents and a question), then, once it has finished, an aLoRA
evaluation of the answer by one adapter (prompt = the base prompt, its
output and the adapter's invocation tokens), then, in the share
``final_share`` of sessions, a final base request that continues the
conversation (prompt = the evaluation's prompt and output and some new
tokens).

Parameters (the mix file): ``base_prompt`` {median, sigma, min, max},
``base_output``, ``eval_output``, ``final_new_tokens``, ``final_output``
([lo, hi] each), ``final_share``.  Token ids and lengths only."""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

from alora_bench import draws
from alora_bench.draws import Turn


class Session:
    def __init__(self, base: Turn, adapter: int, invocation: Sequence[int],
                 eval_out: int, final: Optional[Tuple[List[int], int]]):
        self.base, self.adapter, self.invocation = base, adapter, invocation
        self.eval_out, self.final = eval_out, final
        self.turn = 0

    def first(self) -> Turn:
        return self.base

    def follow(self, prompt: List[int], output: List[int]) -> Optional[Turn]:
        """The next turn after one with ``prompt`` produced ``output``."""
        self.turn += 1
        if self.turn == 1:
            return Turn(prompt + output + list(self.invocation),
                        self.eval_out, self.adapter, "eval")
        if self.turn == 2 and self.final is not None:
            new, out = self.final
            return Turn(prompt + output + new, out, None, "final")
        return None


def make(params: dict, *, seed: int, rate: float, vocab: Tuple[int, int],
         invocations: Sequence[Sequence[int]]
         ) -> Iterator[Tuple[float, Session]]:
    """Sessions with their arrival offsets (seconds), in order."""
    sizes = draws.make_rng(seed, "sessions.sizes")
    ids = draws.make_rng(seed, "sessions.ids")
    n, t = draws.BLOCK, 0.0
    while True:
        gaps = draws.exponential_gaps(rate, n, sizes)
        plen = draws.lognormal_ints(params["base_prompt"], n, sizes)
        bout = draws.uniform_ints(params["base_output"], n, sizes)
        eout = draws.uniform_ints(params["eval_output"], n, sizes)
        fnew = draws.uniform_ints(params["final_new_tokens"], n, sizes)
        fout = draws.uniform_ints(params["final_output"], n, sizes)
        final = draws.shares(params["final_share"], n, sizes)
        adapter = draws.spread(n, len(invocations), sizes)
        for i in range(n):
            t += float(gaps[i])
            a = int(adapter[i])
            base = Turn(draws.token_ids(int(plen[i]), vocab, ids),
                        int(bout[i]), None, "base")
            fin = (draws.token_ids(int(fnew[i]), vocab, ids), int(fout[i])) \
                if final[i] else None
            yield t, Session(base, a, invocations[a], int(eout[i]), fin)
