"""Ragged grouped-LoRA delta: the hand-written Hopper kernel that
replaces the reference's TPU kernel
``repro/kernels/ragged_lora.py::ragged_grouped_lora`` (and its padding
wrapper ``ragged_grouped_lora_padded``), with its plain PyTorch version
beside it.

  delta[t] = (x[t] @ A[s_t]) @ B[s_t]   if s_t > 0 and s_t in active_slots
           = 0                          otherwise

``active_slots`` is the step's ascending, 0-padded list of adapter slots
its tokens reference; slot 0 is the permanently-zero adapter.  The CUDA
source (``repro_torch/csrc/ragged_lora.cu``) runs it SGMV-style in two
stages, shrink then expand, and masks its own ragged edges, so no
padding of T or of the output width is needed.

``ragged_grouped_lora`` sends a CUDA tensor to the kernel and a CPU
tensor to :func:`ragged_grouped_lora_ref`; ``ragged_grouped_lora.launches``
counts calls that launched the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_MAX_RANK = 256           # the shrink stage keeps one thread per rank column


def ragged_grouped_lora_ref(x: torch.Tensor, a_stack: torch.Tensor,
                            b_stack: torch.Tensor, adapter_idx: torch.Tensor,
                            active_slots: torch.Tensor) -> torch.Tensor:
    """Plain version (a port of the reference's
    ``ragged_grouped_lora_ref``): a masked product per active slot,
    summed in slot order in x's dtype.

    x: (T, d); a_stack: (S+1, d, r); b_stack: (S+1, r, out); adapter_idx:
    (T,) int32; active_slots: (K,) int32.  Returns (T, out).

    It agrees with the dense ``models.layers.lora_delta`` within
    rounding: inactive slots add exact zeros, but each product may sum in
    another order."""
    acc = torch.zeros((x.shape[0], b_stack.shape[-1]), dtype=x.dtype,
                      device=x.device)
    for s in active_slots.tolist():
        if s <= 0:                    # slot 0 is the zero adapter
            continue
        sel = (adapter_idx == s)[:, None].to(x.dtype)
        acc = acc + ((x * sel) @ a_stack[s]) @ b_stack[s]
    return acc


def _check(x, a_stack, b_stack, adapter_idx, active_slots):
    dev = x.device
    for name, t in (("a_stack", a_stack), ("b_stack", b_stack),
                    ("adapter_idx", adapter_idx),
                    ("active_slots", active_slots)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: the kernel takes float32 or "
                        "bfloat16")
    if a_stack.dtype != x.dtype or b_stack.dtype != x.dtype:
        raise TypeError("x, a_stack and b_stack must share one dtype")
    for name, t in (("adapter_idx", adapter_idx),
                    ("active_slots", active_slots)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("x", x), ("a_stack", a_stack), ("b_stack", b_stack),
                    ("adapter_idx", adapter_idx),
                    ("active_slots", active_slots)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 2 or a_stack.dim() != 3 or b_stack.dim() != 3:
        raise ValueError("expected x (T,d), a_stack (S+1,d,r) and b_stack "
                         "(S+1,r,out)")
    T, d = x.shape
    n, d_a, r = a_stack.shape
    if d_a != d or b_stack.shape[:2] != (n, r):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, a_stack "
                         f"{tuple(a_stack.shape)}, b_stack "
                         f"{tuple(b_stack.shape)}")
    if adapter_idx.shape != (T,) or active_slots.dim() != 1:
        raise ValueError("adapter_idx must be (T,), active_slots (K,)")
    if r > _MAX_RANK:
        raise ValueError(f"rank {r} above the kernel's {_MAX_RANK}")


def ragged_grouped_lora(x: torch.Tensor, a_stack: torch.Tensor,
                        b_stack: torch.Tensor, adapter_idx: torch.Tensor,
                        active_slots: torch.Tensor) -> torch.Tensor:
    """Shapes as in :func:`ragged_grouped_lora_ref`.  On a CUDA tensor
    the kernel runs: fp32 accumulation, ``x @ A`` rounded once to x's
    dtype (as the TPU kernel does), the expand accumulated in fp32 and
    rounded once."""
    if x.device.type == "cpu":
        return ragged_grouped_lora_ref(x, a_stack, b_stack, adapter_idx,
                                       active_slots)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, a_stack, b_stack, adapter_idx, active_slots)
    T, d = x.shape
    n, _, r = a_stack.shape
    out_dim = b_stack.shape[-1]
    out = torch.empty((T, out_dim), dtype=x.dtype, device=x.device)
    if T == 0 or out_dim == 0:
        return out
    xa = torch.empty((T, r), dtype=x.dtype, device=x.device)
    lib = build.load()
    err = lib.ragged_grouped_lora(
        x.data_ptr(), a_stack.data_ptr(), b_stack.data_ptr(),
        adapter_idx.data_ptr(), active_slots.data_ptr(), xa.data_ptr(),
        out.data_ptr(), T, d, r, out_dim, n, active_slots.shape[0],
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ragged_grouped_lora")
    ragged_grouped_lora.launches += 1
    return out


ragged_grouped_lora.launches = 0
