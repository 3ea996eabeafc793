"""Seeded draws shared by the traffic generators.

Every seed gets the same work in another order: sizes and arrival gaps
are taken at fixed, evenly spaced quantiles of their distributions in
blocks of ``BLOCK`` items, and the seed only orders each block and
draws the token ids.  The order is stratified: every aligned run of
``STRATA`` items of a block holds one value of each of the block's
``STRATA`` strata (its sorted values cut into equal slices), so a few
seconds of arrivals hold much the same lengths on every seed, and a
window that opens and closes inside a block does not draw the long
prompts or the short gaps of one seed only.  Runs on different seeds
then offer the same load, and their spread is the system's, not the
dice's."""
from __future__ import annotations

import zlib
from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np

BLOCK = 64
STRATA = 8


def quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def stratified(v: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """The values of ``v`` in a seeded order in which each aligned run of
    ``STRATA`` items holds one value of each stratum of ``v`` (a slice
    of ``len(v) // STRATA`` neighbours in sorted order).  ``len(v)`` is a
    multiple of ``STRATA``."""
    k = STRATA
    m = len(v) // k
    strata = np.sort(v).reshape(k, m)
    pick = np.stack([rng.permutation(m) for _ in range(k)])
    runs = [rng.permutation(strata[np.arange(k), pick[:, i]])
            for i in range(m)]
    return np.concatenate(runs)


def lognormal_ints(spec: Dict, n: int, rng: np.random.Generator
                   ) -> np.ndarray:
    """``n`` lengths from a lognormal with ``median`` and ``sigma``,
    clipped to [``min``, ``max``], in a seeded order."""
    z = np.array([NormalDist().inv_cdf(q) for q in quantiles(n)])
    v = np.clip(np.round(spec["median"] * np.exp(spec["sigma"] * z)),
                spec["min"], spec["max"]).astype(np.int64)
    return stratified(v, rng)


def uniform_ints(lo_hi: List[int], n: int, rng: np.random.Generator
                 ) -> np.ndarray:
    """``n`` integers uniform on [lo, hi], in a seeded order."""
    lo, hi = lo_hi
    v = lo + np.floor(quantiles(n) * (hi - lo + 1)).astype(np.int64)
    return stratified(v, rng)


def exponential_gaps(rate: float, n: int, rng: np.random.Generator
                     ) -> np.ndarray:
    """``n`` Poisson inter-arrival gaps (seconds) at ``rate`` per second,
    in a seeded order; each block sums to the same span."""
    v = -np.log1p(-quantiles(n)) / rate
    return stratified(v, rng)


def spread(n: int, k: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` labels 0..k-1 as evenly as ``n`` allows, in a seeded order."""
    return stratified(np.arange(n) % k, rng)


def shares(share: float, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` flags, the share ``share`` of them set, in a seeded order."""
    return stratified(quantiles(n) < share, rng)


def token_ids(n: int, vocab: Tuple[int, int], rng: np.random.Generator
              ) -> List[int]:
    """``n`` ids uniform on [vocab[0], vocab[1])."""
    return rng.integers(vocab[0], vocab[1], size=n).tolist()


def make_rng(seed: int, stream: str) -> np.random.Generator:
    """A generator for one named stream of draws of ``seed`` (any
    non-negative integer, beyond 32 bits too)."""
    return np.random.default_rng([int(seed) % (1 << 63), int(seed) >> 63,
                                  zlib.crc32(stream.encode())])


class Turn:
    """One request of a session: its prompt ids, output length, adapter
    (an index into the configuration's adapters, or None for the base
    model) and kind ("base", "eval", "final", "chat")."""
    __slots__ = ("prompt", "max_new", "adapter", "kind")

    def __init__(self, prompt: List[int], max_new: int, adapter, kind: str):
        self.prompt, self.max_new = prompt, max_new
        self.adapter, self.kind = adapter, kind
