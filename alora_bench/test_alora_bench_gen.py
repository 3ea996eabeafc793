"""The traffic generators: each one's draws for a seed are pinned, every
seed offers the same sizes and arrival gaps in another order, and a
session's turns follow the mix (base → aLoRA evaluation of its answer →
a final base turn in half of the sessions)."""
from __future__ import annotations

import json
import zlib
from pathlib import Path

import pytest

from alora_bench import spec

BENCH = Path(__file__).resolve().parent
INV = [(100 - 3 * a - 1, 100 - 3 * a - 2, 100 - 3 * a - 3) for a in range(8)]
SEED = 2 ** 40 + 7


def stream(gen, mix, seed, rate):
    make = spec.load_module(BENCH / "gen" / f"{gen}.py").make
    m = json.loads((BENCH / "mixes" / f"{mix}.json").read_text())
    return make(m, seed=seed, rate=rate, vocab=(1, 49000), invocations=INV)


def test_sessions_draws_are_pinned():
    g = stream("sessions", "rag-alora-sessions", SEED, 2.0)
    rows = []
    for _ in range(5):
        t, s = next(g)
        b = s.first()
        rows.append([round(t, 6), len(b.prompt), b.max_new, s.adapter,
                     s.eval_out, s.final is not None,
                     zlib.crc32(str(b.prompt).encode())])
    assert rows == [
        [1.876709, 2713, 88, 7, 15, True, 2224429121],
        [1.888567, 911, 79, 2, 13, False, 3359064957],
        [2.037644, 2162, 55, 6, 8, True, 2784324877],
        [2.136679, 4940, 40, 1, 13, False, 3837010080],
        [2.81444, 1817, 35, 5, 15, False, 2788907372]]


def test_independent_draws_are_pinned():
    g = stream("independent", "chat-short", SEED, 8.0)
    rows = []
    for _ in range(5):
        t, s = next(g)
        b = s.first()
        rows.append([round(t, 6), len(b.prompt), b.max_new, b.adapter,
                     zlib.crc32(str(b.prompt).encode())])
    assert rows == [[0.080917, 549, 228, 6, 1078569607],
                    [0.444182, 167, 195, None, 799233639],
                    [0.613623, 797, 104, 5, 1178668641],
                    [0.817767, 244, 152, None, 1171823144],
                    [0.866032, 1178, 68, None, 3773620296]]


@pytest.mark.parametrize("gen,mix", [("sessions", "rag-alora-sessions"),
                                     ("independent", "chat-short")])
def test_every_seed_offers_the_same_work(gen, mix):
    """A block of 64 arrivals: the same lengths and the same span of
    arrivals on every seed, in another order."""
    def block(seed):
        g = stream(gen, mix, seed, 3.0)
        items = [next(g) for _ in range(64)]
        sizes = (sorted(len(s.first().prompt) for _, s in items),
                 sorted(s.first().max_new for _, s in items))
        return items[-1][0], sizes, [s.first().prompt[:4] for _, s in items]
    t1, s1, p1 = block(1)
    t2, s2, p2 = block(2 ** 33 + 5)
    assert t1 == pytest.approx(t2)
    assert s1 == s2 and p1 != p2


@pytest.mark.parametrize("gen,mix", [("sessions", "rag-alora-sessions"),
                                     ("independent", "chat-short")])
def test_every_few_arrivals_hold_each_stratum(gen, mix):
    """Each aligned run of ``STRATA`` arrivals holds one prompt length of
    each stratum of its block, so a window that cuts a block still sees
    the block's spread of lengths on every seed."""
    from alora_bench.draws import BLOCK, STRATA
    g = stream(gen, mix, 2 ** 35 + 3, 3.0)
    lens = [len(next(g)[1].first().prompt) for _ in range(2 * BLOCK)]
    for b in range(0, len(lens), BLOCK):
        block = lens[b:b + BLOCK]
        cuts = sorted(block)[::BLOCK // STRATA]
        for r in range(0, BLOCK, STRATA):
            run = sorted(block[r:r + STRATA])
            # the i-th smallest of a run lies in the i-th stratum
            assert all(cuts[i] <= x for i, x in enumerate(run))
            assert all(x <= cuts[i + 1] for i, x in enumerate(run[:-1]))


def test_session_turns_follow_the_mix():
    g = stream("sessions", "rag-alora-sessions", 3, 2.0)
    finals = 0
    for _ in range(64):
        _, s = next(g)
        base = s.first()
        assert base.adapter is None and base.kind == "base"
        assert 512 <= len(base.prompt) <= 6144
        assert all(1 <= t < 49000 for t in base.prompt)
        out = list(range(base.max_new))
        ev = s.follow(base.prompt, out)
        assert ev.kind == "eval" and ev.adapter == s.adapter
        assert ev.prompt == base.prompt + out + list(INV[s.adapter])
        assert 8 <= ev.max_new <= 16
        fin = s.follow(ev.prompt, [7] * ev.max_new)
        if fin is not None:
            finals += 1
            assert fin.kind == "final" and fin.adapter is None
            assert fin.prompt[:len(ev.prompt) + ev.max_new] \
                == ev.prompt + [7] * ev.max_new
            assert 16 <= len(fin.prompt) - len(ev.prompt) - ev.max_new <= 32
            assert s.follow(fin.prompt, [1]) is None
    assert finals == 32


def test_chat_requests_invoke_their_adapter_at_the_end():
    g = stream("independent", "chat-short", 5, 8.0)
    turns = [next(g)[1].first() for _ in range(64)]
    adapted = [t for t in turns if t.adapter is not None]
    assert len(adapted) == 32
    for t in adapted:
        assert tuple(t.prompt[-3:]) == INV[t.adapter]
    assert all(64 <= len(t.prompt) <= 2048 and 64 <= t.max_new <= 256
               for t in turns)
