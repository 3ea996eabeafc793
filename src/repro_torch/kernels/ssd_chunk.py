"""Ragged SSD scan: the hand-written Hopper kernel that replaces the
reference's TPU kernel ``repro/kernels/ssd_chunk.py::ragged_ssd_chunk_scan``,
with its plain PyTorch version beside it.

The mixed serving step packs every scheduled token of the SSM layers
(decode singletons and prefill chunks) along one token axis; each
request's tokens form a contiguous segment.  At a segment start the
recurrent state is gathered from ``init_states[slot_rows[t]]``; inside a
segment the per-token recurrence runs on:

  state_t = exp(dA_t) * entry + dt_t * (B_t ⊗ x_t);   y_t = C_t · state_t

Both versions return the post-token state at every packed position; the
caller gathers the segment-final rows for the live pool and the
block-boundary rows for the prefix cache's snapshots.  The CUDA source
(``repro_torch/csrc/ssd_chunk.cu``) runs the recurrent form, one block
per (head, 16-column tile of P); the Pallas kernel's ``seg_ids`` input
(needed only by its chunked form) and its padding of T to a chunk
multiple are not needed.

``ragged_ssd_chunk_scan`` sends a CUDA tensor to the kernel and a CPU
tensor to :func:`ragged_ssd_scan_ref`; ``ragged_ssd_chunk_scan.launches``
counts kernel launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

_P_TILE = 16              # P columns per thread block
_MAX_N = 256              # one thread per state row


def ragged_ssd_scan_ref(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                        dA: torch.Tensor, dt: torch.Tensor,
                        seg_starts: torch.Tensor, slot_rows: torch.Tensor,
                        init_states: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version (a port of ``repro/kernels/ref.py``'s
    ``ragged_ssd_scan_ref``): one step of the recurrence per packed token.

    x: (T, H, P); B/C: (T, H, N); dA/dt: (T, H) float32; seg_starts: (T,)
    bool or int (non-zero: the token starts its request's segment);
    slot_rows: (T,) int — token → row of ``init_states`` (S, H, N, P)
    float32.  Returns (y (T, H, P) in x's dtype, states (T, H, N, P)
    float32).  No host synchronisation: the entry state is selected on
    the device."""
    T, H, P = x.shape
    N = B.shape[-1]
    xf, Bf, Cf = x.float(), B.float(), C.float()
    starts = seg_starts.bool()
    slots = slot_rows.long()
    state = torch.zeros((H, N, P), dtype=torch.float32, device=x.device)
    ys = torch.empty((T, H, P), dtype=torch.float32, device=x.device)
    states = torch.empty((T, H, N, P), dtype=torch.float32, device=x.device)
    for t in range(T):
        entry = torch.where(starts[t], init_states[slots[t]], state)
        state = torch.exp(dA[t])[:, None, None] * entry + \
            (Bf[t] * dt[t][:, None])[:, :, None] * xf[t][:, None, :]
        ys[t] = torch.einsum("hn,hnp->hp", Cf[t], state)
        states[t] = state
    return ys.to(x.dtype), states


def _check(x, B, C, dA, dt, seg_starts, slot_rows, init_states):
    dev = x.device
    named = (("x", x), ("B", B), ("C", C), ("dA", dA), ("dt", dt),
             ("seg_starts", seg_starts), ("slot_rows", slot_rows),
             ("init_states", init_states))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in named[:5] + named[7:]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} dtype {t.dtype}: the kernel takes "
                            "float32")
    for name, t in named[5:7]:
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if x.dim() != 3 or B.dim() != 3 or init_states.dim() != 4:
        raise ValueError("expected x (T,H,P), B/C (T,H,N) and init_states "
                         "(S,H,N,P)")
    T, H, P = x.shape
    N = B.shape[-1]
    if B.shape != (T, H, N) or C.shape != (T, H, N) \
            or dA.shape != (T, H) or dt.shape != (T, H) \
            or seg_starts.shape != (T,) or slot_rows.shape != (T,) \
            or init_states.shape[1:] != (H, N, P):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, B {tuple(B.shape)}, C "
            f"{tuple(C.shape)}, dA {tuple(dA.shape)}, dt {tuple(dt.shape)}, "
            f"init_states {tuple(init_states.shape)}")
    if P % _P_TILE or N > _MAX_N:
        raise ValueError(f"the kernel takes P a multiple of {_P_TILE} and "
                         f"N <= {_MAX_N}, got P={P}, N={N}")
    for name, t in (("x", x), ("init_states", init_states)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def ragged_ssd_chunk_scan(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                          dA: torch.Tensor, dt: torch.Tensor,
                          seg_starts: torch.Tensor, slot_rows: torch.Tensor,
                          init_states: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shapes as in :func:`ragged_ssd_scan_ref`.  On a CUDA tensor the
    kernel runs (every input float32 except ``seg_starts`` and
    ``slot_rows``, which are int32); on a CPU tensor the plain version
    does.  Returns (y (T, H, P), states (T, H, N, P)), float32."""
    if x.device.type == "cpu":
        return ragged_ssd_scan_ref(x, B, C, dA, dt, seg_starts, slot_rows,
                                   init_states)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, B, C, dA, dt, seg_starts, slot_rows, init_states)
    T, H, P = x.shape
    N = B.shape[-1]
    y = torch.empty((T, H, P), dtype=torch.float32, device=x.device)
    states = torch.empty((T, H, N, P), dtype=torch.float32, device=x.device)
    if T == 0:
        return y, states
    lib = build.load()
    err = lib.ragged_ssd_chunk_scan(
        x.data_ptr(), B.data_ptr(), C.data_ptr(), dA.data_ptr(),
        dt.data_ptr(), seg_starts.data_ptr(), slot_rows.data_ptr(),
        init_states.data_ptr(), y.data_ptr(), states.data_ptr(), T, H, N, P,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ragged_ssd_chunk_scan")
    ragged_ssd_chunk_scan.launches += 1
    return y, states


ragged_ssd_chunk_scan.launches = 0
