"""SSD scans: the hand-written Hopper kernels that replace the
reference's two TPU kernels of ``repro/kernels/ssd_chunk.py``, each with
its plain PyTorch version beside it.  Both run the Mamba2 recurrence

  state_t = exp(dA_t) * state_{t-1} + dt_t * (B_t ⊗ x_t);   y_t = C_t · state_t

``ragged_ssd_chunk_scan`` is the mixed serving step's scan.  The step
packs every scheduled token of the SSM layers (decode singletons and
prefill chunks) along one token axis; each request's tokens form a
contiguous segment, and at a segment start the state is gathered from
``init_states[slot_rows[t]]``.  It returns y at every position and the
post-token state only at the positions ``out_rows`` names (the runner
asks for each request's last token, for the live pool, and the
block-boundary tokens, for the prefix cache's snapshots).  The CUDA
source (``repro_torch/csrc/ssd_chunk.cu``) runs the recurrent form, one
block per (head, 32 columns of P), a lane per (four columns, sixteenth
of the state rows); :func:`ragged_plan` gives its launch from the shapes
alone.
The Pallas kernel's ``seg_ids`` input (needed only by its chunked form)
and its padding of T to a chunk multiple are not needed.

``ssd_chunk_scan`` is the dense, batched scan over full sequences from a
zero state; it returns every y and the final state.  Its CUDA source
(``repro_torch/csrc/ssd_chunk_dense.cu``) runs the chunked SSD form on
tensor cores in 3xTF32, one block per (head, slice of P, row), and
needs no padding of S either; :func:`dense_plan` gives its launch.

Each wrapper sends a CUDA tensor to its kernel and a CPU tensor to its
plain version (:func:`ssd_chunk_ref`, :func:`ragged_ssd_scan_ref`), and
counts its kernel launches in ``.launches``.  Both kernels take float32
only.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import build

# the ragged scan's launch plan: the CUDA source's kBlockCols and the
# state sizes it is built for; the source sizes each block's shared
# memory and raises for kept rows past it
SCAN_COLS = 32            # P columns per block
SCAN_STATE_DIMS = (16, 32, 64, 128)   # N: a sixteenth of it per lane
SCAN_P_STEP = 8           # P a multiple of this
# the dense scan's launch plan: the CUDA source's kWarpCols and
# kMaxWarps, the state sizes and the chunk length it is built for
DENSE_N = (16, 32, 64, 96, 128)   # N: the state's columns in registers
DENSE_CHUNK = 32                  # Q, tokens per chunk
DENSE_TILES = 6                   # C . B^T's lower-triangle 16 x 8 tiles
DENSE_WARP_COLS = 16              # columns of P per warp
DENSE_MAX_COLS = 64               # columns of P per block, at most
DENSE_STAGES = (2, 3, 4)          # chunks in the cp.async ring
DENSE_SMEM_TARGET = 110 * 1024    # two blocks share an SM's 228 KB
SMS = 132                         # H100 SXM


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


@dataclass(frozen=True)
class ScanPlan:
    """How the ragged scan covers a call, from the shapes alone."""
    grid: Tuple[int, int]     # (H, P column tiles): one block each


@functools.lru_cache(maxsize=256)
def ragged_plan(T: int, H: int, N: int, P: int, M: int) -> ScanPlan:
    """The launch of one call with x (T, H, P), B/C (T, H, N) and M kept
    state rows.  Raises ``ValueError`` for a shape the kernel does not
    take."""
    if N not in SCAN_STATE_DIMS:
        raise ValueError(f"state size N={N}: the kernel is built for "
                         f"{SCAN_STATE_DIMS}")
    if P <= 0 or P % SCAN_P_STEP or H <= 0:
        raise ValueError(f"P={P} must be a positive multiple of "
                         f"{SCAN_P_STEP}, H={H} positive")
    if T < 0 or M < 0:
        raise ValueError(f"T {T} and M {M} must not be negative")
    return ScanPlan(grid=(H, -(-P // SCAN_COLS)))


def _check(x, B, C, dA, dt, seg_starts, slot_rows, init_states,
           out_rows) -> ScanPlan:
    dev = x.device
    named = (("x", x), ("B", B), ("C", C), ("dA", dA), ("dt", dt),
             ("seg_starts", seg_starts), ("slot_rows", slot_rows),
             ("init_states", init_states), ("out_rows", out_rows))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in named[:5] + named[7:8]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} dtype {t.dtype}: the kernel takes "
                            "float32")
    for name, t in named[5:7] + named[8:]:
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
            or init_states.shape[1:] != (H, N, P) or out_rows.dim() != 1:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, B {tuple(B.shape)}, C "
            f"{tuple(C.shape)}, dA {tuple(dA.shape)}, dt {tuple(dt.shape)}, "
            f"init_states {tuple(init_states.shape)}, out_rows "
            f"{tuple(out_rows.shape)}")
    for name, t in named[:3] + named[7:8]:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return ragged_plan(T, H, N, P, out_rows.shape[0])


def ragged_ssd_chunk_scan(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                          dA: torch.Tensor, dt: torch.Tensor,
                          seg_starts: torch.Tensor, slot_rows: torch.Tensor,
                          init_states: torch.Tensor, out_rows: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shapes as in :func:`ragged_ssd_scan_ref`, and ``out_rows`` (M,)
    int32: packed positions in [0, T) whose post-token states to return,
    in any order, repeats allowed (``arange(T)`` gives the reference's
    every-position output).  On a CUDA tensor the kernel runs (every
    input float32 except ``seg_starts``, ``slot_rows`` and ``out_rows``,
    which are int32); on a CPU tensor the plain version does, and its
    states are gathered at ``out_rows``.  Returns (y (T, H, P), states
    (M, H, N, P)), float32.  An ``out_rows`` entry outside [0, T) is the
    caller's error, not checked on the card (that would read device
    data): the CPU path raises, the kernel writes zeros to its row."""
    if x.device.type == "cpu":
        y, states = ragged_ssd_scan_ref(x, B, C, dA, dt, seg_starts,
                                        slot_rows, init_states)
        return y, states.index_select(0, out_rows.long())
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = _launch(x, B, C, dA, dt, seg_starts, slot_rows, init_states,
                  out_rows)
    if x.shape[0]:
        ragged_ssd_chunk_scan.launches += 1
    return out


ragged_ssd_chunk_scan.launches = 0


def _launch(x, B, C, dA, dt, seg_starts, slot_rows, init_states, out_rows
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check, plan and launch the ragged scan kernel."""
    p = _check(x, B, C, dA, dt, seg_starts, slot_rows, init_states,
               out_rows)
    T, H, P = x.shape
    N = B.shape[-1]
    M = out_rows.shape[0]
    y = torch.empty((T, H, P), dtype=torch.float32, device=x.device)
    states = torch.empty((M, H, N, P), dtype=torch.float32, device=x.device)
    if T == 0:
        return y, states.zero_()
    lib = build.load()
    err = lib.ragged_ssd_chunk_scan(
        x.data_ptr(), B.data_ptr(), C.data_ptr(), dA.data_ptr(),
        dt.data_ptr(), seg_starts.data_ptr(), slot_rows.data_ptr(),
        init_states.data_ptr(), out_rows.data_ptr(), y.data_ptr(),
        states.data_ptr(), T, H, N, P, M, *p.grid,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ragged_ssd_chunk_scan")
    return y, states


@dataclass(frozen=True)
class DensePlan:
    """How the dense scan covers a call, from the shapes alone; the
    launch takes every field."""
    chunk: int                # Q, tokens per chunk
    cols: int                 # columns of P per block (16 per warp)
    grid: Tuple[int, int, int]  # (H, P slices, Bt): one block each
    stages: int               # chunks in the cp.async ring
    smem: int                 # dynamic shared memory per block, bytes


def dense_smem(N: int, cols: int, stages: int) -> int:
    """The block's shared memory, as the CUDA source lays it out: per
    stage C and B (Q x (N + 8)), x (Q x (cols + 8)), dA and dt; then W
    (Q x (Q + 4)), per warp its cumulative sums (Q) and its C . B^T
    partials (the tiles' 128 values each), and the rows' two factors."""
    Q = DENSE_CHUNK
    stage = Q * (2 * (N + 8) + cols + 8) + 2 * Q
    return 4 * (stages * stage + Q * (Q + 4)
                + (cols // DENSE_WARP_COLS) * (Q + DENSE_TILES * 128)
                + 2 * Q)


@functools.lru_cache(maxsize=256)
def dense_plan(Bt: int, S: int, H: int, N: int, P: int) -> DensePlan:
    """The launch of one call with x (Bt, S, H, P) and B/C (Bt, S, H, N).

    A block walks one (row, head) over every chunk, for a slice of at
    most 64 columns of P (one warp per 16).  P is cut into more slices
    than that only while Bt * H blocks would leave SMs idle (each slice
    computes the chunk's C . B^T again).  Chunks of 32 tokens, and as
    many stages (at least 2) as keep a block within ~110 KB of shared
    memory: two blocks per SM.
    Raises ``ValueError`` for a shape the kernel does not take."""
    if N not in DENSE_N:
        raise ValueError(f"state size N={N}: the kernel is built for "
                         f"{DENSE_N}")
    if P <= 0 or P % SCAN_P_STEP:
        raise ValueError(f"P={P} must be a positive multiple of "
                         f"{SCAN_P_STEP}")
    if Bt <= 0 or H <= 0 or S < 0:
        raise ValueError(f"Bt {Bt} and H {H} must be positive, S {S} not "
                         "negative")
    step = DENSE_WARP_COLS
    fewest = -(-P // DENSE_MAX_COLS)
    slices = max(fewest, min(-(-P // step), SMS // (Bt * H)))
    cols = -(-(-(-P // slices)) // step) * step
    slices = -(-P // cols)
    stages = max(st for st in DENSE_STAGES if st == DENSE_STAGES[0]
                 or dense_smem(N, cols, st) <= DENSE_SMEM_TARGET)
    return DensePlan(chunk=DENSE_CHUNK, cols=cols, grid=(H, slices, Bt),
                     stages=stages, smem=dense_smem(N, cols, stages))


def ssd_chunk_ref(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                  dA: torch.Tensor, dt: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dense scan (a port of ``repro/kernels/ref.py``'s
    ``ssd_chunk_ref``): one step of the token recurrence per position.

    x: (Bt, S, H, P); B/C: (Bt, S, H, N); dA/dt: (Bt, S, H) float32.
      state_t = exp(dA_t) * state_{t-1} + dt_t * (B_t ⊗ x_t)
      y_t     = C_t · state_t
    Returns (y (Bt, S, H, P) in x's dtype, final state (Bt, H, N, P)
    float32)."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    xf, Bf, Cf = x.float(), B.float(), C.float()
    state = torch.zeros((Bt, H, N, P), dtype=torch.float32, device=x.device)
    ys = torch.empty((Bt, S, H, P), dtype=torch.float32, device=x.device)
    for t in range(S):
        state = torch.exp(dA[:, t])[..., None, None] * state + \
            (Bf[:, t] * dt[:, t, :, None])[..., None] * xf[:, t, :, None, :]
        ys[:, t] = torch.einsum("bhn,bhnp->bhp", Cf[:, t], state)
    return ys.to(x.dtype), state


def ssd_chunk_scan(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                   dA: torch.Tensor, dt: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense scan; shapes as in :func:`ssd_chunk_ref`, any S.  The
    reference kernel's ``chunk`` argument is not taken: its result
    depends on the chunk length only through rounding, and the CUDA
    kernel tiles by :func:`dense_plan`'s.  On a CUDA tensor the kernel
    runs (float32 only; N in ``DENSE_N``, P a multiple of 8); on a CPU
    tensor the plain version does."""
    if x.device.type == "cpu":
        return ssd_chunk_ref(x, B, C, dA, dt)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    build.no_backward("ssd_chunk_scan", x, B, C, dA, dt)
    y, state = _launch_dense(x, B, C, dA, dt)
    if y.numel():
        ssd_chunk_scan.launches += 1
    return y, state


def _check_dense(x, B, C, dA, dt) -> DensePlan:
    named = (("x", x), ("B", B), ("C", C), ("dA", dA), ("dt", dt))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} dtype {t.dtype}: the kernel takes "
                            "float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 4:
        raise ValueError(f"expected x (Bt,S,H,P), got {tuple(x.shape)}")
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    if B.shape != (Bt, S, H, N) or C.shape != (Bt, S, H, N) \
            or dA.shape != (Bt, S, H) or dt.shape != (Bt, S, H):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, B {tuple(B.shape)}, C "
            f"{tuple(C.shape)}, dA {tuple(dA.shape)}, dt {tuple(dt.shape)}")
    for name, t in named[:3]:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return dense_plan(Bt, S, H, N, P)


def _launch_dense(x, B, C, dA, dt) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check, plan and launch the dense scan kernel."""
    p = _check_dense(x, B, C, dA, dt)
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    y = torch.empty((Bt, S, H, P), dtype=torch.float32, device=x.device)
    state = torch.empty((Bt, H, N, P), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, state.zero_()
    lib = build.load()
    err = lib.ssd_chunk_scan(
        x.data_ptr(), B.data_ptr(), C.data_ptr(), dA.data_ptr(),
        dt.data_ptr(), y.data_ptr(), state.data_ptr(), Bt, S, H, N, P,
        p.chunk, p.cols, p.grid[1], p.stages,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ssd_chunk_scan")
    return y, state


ssd_chunk_scan.launches = 0
