"""What every family's draw shares: the weights and adapters are drawn by
the harness on the device from the seed, in the type they are served in
and in a few large calls: one flat buffer per standard deviation class,
filled in slices of 2**30 elements, of which every weight matrix is a
view (``Flat``).  The same tensors go to the program (in its parameter
layout) and to the reference (layer by layer), which upcasts them
itself."""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

FILL_CHUNK = 1 << 30
PAD_VOCAB = 512          # the port's embedding rows, rounded up


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


class Flat:
    """Shapes laid out back to back in one buffer, by class of standard
    deviation, drawn from N(0, 1) and scaled per class."""

    def __init__(self):
        self.items: List[Tuple[Tuple[int, ...], float]] = []

    def add(self, shape: Sequence[int], std: float) -> int:
        self.items.append((tuple(shape), std))
        return len(self.items) - 1

    def draw(self, gen: torch.Generator, dtype, device) -> List[torch.Tensor]:
        order = sorted(range(len(self.items)), key=lambda i: self.items[i][1])
        sizes = [math.prod(self.items[i][0]) for i in order]
        buf = torch.empty(sum(sizes), dtype=dtype, device=device)
        for lo in range(0, buf.numel(), FILL_CHUNK):
            buf[lo:lo + FILL_CHUNK].normal_(generator=gen)
        out: List[Optional[torch.Tensor]] = [None] * len(self.items)
        off, run_lo, run_std = 0, 0, None
        for i, n in zip(order, sizes):
            std = self.items[i][1]
            if std != run_std:
                if run_std is not None:
                    buf[run_lo:off].mul_(run_std)
                run_lo, run_std = off, std
            out[i] = buf[off:off + n].view(self.items[i][0])
            off += n
        if run_std is not None:
            buf[run_lo:off].mul_(run_std)
        return out
