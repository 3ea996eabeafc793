"""What every family's plain reference shares: float32 PyTorch with TF32
off, with no kernel, cache or batching of the program, importing nothing
of the program and taking only what the harness drew (the weights, the
adapters, the token ids).

* ``Seq``: a sequence to score, and ``find_last`` of an invocation;
* the plain operations of the repo's models: ``rmsnorm``, ``rope``,
  ``causal_attention`` (in query blocks), ``ssd_scan`` (the SSD
  recurrence from a zero state, in chunks);
* ``Plain``: a reference's products.  ``quant="fp8"`` computes every
  product with both operands rounded to float8 e4m3 (weights per output
  column, activations per row): the control, one precision below the
  configuration's bfloat16.  ``quant="bf16"`` rounds them to bfloat16:
  the control of the float32 configurations the CPU tests run.

A family's reference (``reference/<family>.py``) defines ``Reference``,
a subclass of ``Plain`` whose ``logits(seqs)`` walks its model.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

Q_BLOCK = 512            # attention query rows per block
SSD_CHUNK = 64           # the scan's chunk length
FP8_MAX = 448.0          # the largest finite float8 e4m3 value


@dataclass
class Seq:
    """A sequence to score: ``tokens`` (a prompt and the served tokens
    but the last), the adapter index (None: the base model) and where it
    activates, and the positions whose logits are returned."""
    tokens: List[int]
    adapter: Optional[int]
    inv_start: int
    want: List[int]


def find_last(tokens: Sequence[int], pattern: Sequence[int]) -> Optional[int]:
    """Start of the last occurrence of ``pattern`` in ``tokens``."""
    m = len(pattern)
    for s in range(len(tokens) - m, -1, -1):
        if list(tokens[s:s + m]) == list(pattern):
            return s
    return None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (S, heads, hd) at positions 0..S-1, the two
    halves of each head rotated as a pair."""
    S, _, hd = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """q (S, H, hd), k/v (S, KV, hd) -> (S, H, hd), in query blocks."""
    S, H, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(hd)
    for a in range(0, S, Q_BLOCK):
        b = min(S, a + Q_BLOCK)
        qb = q[a:b].reshape(b - a, KV, G, hd)
        s = torch.einsum("qkgd,skd->kgqs", qb, k[:b]) * scale
        keep = torch.arange(b, device=q.device)[None, :] \
            <= torch.arange(a, b, device=q.device)[:, None]
        s = s.masked_fill(~keep, float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[a:b] = torch.einsum("kgqs,skd->qkgd", p, v[:b]).reshape(
            b - a, H, hd)
    return out


def ssd_scan(xs: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             dt: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """The SSD recurrence from a zero state, in chunks: exact within a
    chunk (its lower-triangular decay matrix), a recurrence on the
    (heads, N, P) state across chunks.  xs (S, nh, P); Bm, Cm (S, nh,
    N); dt (S, nh); A (nh,).  Returns y (S, nh, P) without the D term."""
    S, nh, P = xs.shape
    N = Bm.shape[-1]
    Q = SSD_CHUNK
    pad = (-S) % Q
    nc = (S + pad) // Q

    def chunks(t):
        t = F.pad(t, (0, 0) * (t.dim() - 1) + (0, pad))
        return t.reshape((nc, Q) + t.shape[1:])

    xc, Bc, Cc, dtc = map(chunks, (xs, Bm, Cm, dt))
    cs = torch.cumsum(dtc * A, dim=1)                       # (nc, Q, nh)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=xs.device).tril()
    diff = cs[:, :, None, :] - cs[:, None, :, :]            # (nc, Qi, Qj, nh)
    decay = torch.exp(diff.masked_fill(~tri[None, :, :, None],
                                       float("-inf")))
    cb = torch.einsum("cihn,cjhn->cijh", Cc, Bc)
    y = torch.einsum("cijh,cjhp->cihp", cb * decay * dtc[:, None, :, :], xc)
    to_end = torch.exp(cs[:, -1:, :] - cs)                  # (nc, Q, nh)
    chunk_state = torch.einsum("cjhn,cjhp->chnp",
                               Bc * (dtc * to_end)[..., None], xc)
    state = torch.zeros((nh, N, P), dtype=torch.float32, device=xs.device)
    entry = []
    for c in range(nc):
        entry.append(state)
        state = torch.exp(cs[c, -1])[:, None, None] * state + chunk_state[c]
    y = y + torch.einsum("cihn,chnp->cihp", Cc * torch.exp(cs)[..., None],
                         torch.stack(entry))
    return y.reshape(nc * Q, nh, P)[:S]


def _fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per row (last dim)."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


ROUND = {"fp8": _fp8_rows, "bf16": _bf16}


class Plain:
    """The products of a reference over ``weights`` (the harness's tree,
    any dtype) and ``adapters`` (per layer, per adapter: the family's
    {name: (A, B)}), in float32 or, with ``quant``, on rounded operands
    (the control)."""

    def __init__(self, dims: Dict[str, Any], weights: Dict[str, Any],
                 adapters: List[List[Dict[str, Any]]], device,
                 quant: Optional[str] = None):
        if quant is not None and quant not in ROUND:
            raise ValueError(f"unknown quant {quant!r}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dims, self.w, self.adapters = dims, weights, adapters
        self.device = device
        self.round = ROUND.get(quant)

    # a product, in float32 or (the control) with rounded operands
    def _weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.to(self.device, torch.float32)
        return self.round(w.T).T if self.round else w

    def _lin(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return (self.round(x) if self.round else x) @ w

    def _delta(self, h: torch.Tensor, ab, start: int) -> torch.Tensor:
        a, b = (self._weight(t) for t in ab)
        out = torch.zeros((h.shape[0], b.shape[1]), dtype=torch.float32,
                          device=h.device)
        out[start:] = self._lin(self._lin(h[start:], a), b)
        return out

    def _adapted(self, h, s: Seq, li: int, name: str):
        if s.adapter is None:
            return None
        return self._delta(h, self.adapters[li][s.adapter][name], s.inv_start)
