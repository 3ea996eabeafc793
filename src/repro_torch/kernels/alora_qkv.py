"""Fused aLoRA QKV projection: the hand-written Hopper kernel that
replaces the reference's TPU kernel ``repro/kernels/alora_qkv.py::alora_qkv``
(and its padding wrapper ``repro.kernels.ops.alora_qkv_op``), with its
plain PyTorch version beside it.

  out[t] = x[t] @ W + (x[t] @ A[idx_t]) @ B[idx_t]   if 1 <= idx_t < n
  out[t] = x[t] @ W                                   otherwise

Adapter 0 is the zero adapter (base-model tokens and the tokens before
an aLoRA request's invocation): it is skipped whatever ``A[0]`` holds.
The CUDA source (``repro_torch/csrc/alora_qkv.cu``) computes the base
product itself, on tensor cores in bfloat16, and masks its own edges,
so T and the output width need no padding.

``alora_qkv`` sends a CUDA tensor to the kernel and a CPU tensor to
:func:`alora_qkv_ref`; ``alora_qkv.launches`` counts calls that launched
the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_MAX_RANK = 256           # the shrink stage keeps one thread per rank column
_RANK_PAD = 32            # x @ A is staged with its rank padded to this
_ALIGN = 8                # d and the output width: 16-byte rows


def alora_qkv_ref(x: torch.Tensor, w: torch.Tensor, a_stack: torch.Tensor,
                  b_stack: torch.Tensor,
                  adapter_idx: torch.Tensor) -> torch.Tensor:
    """Plain version (a port of ``repro/kernels/ref.py``'s
    ``alora_qkv_ref``): the base product plus a masked product per
    adapter 1..n-1, in x's dtype.

    x: (T, d); w: (d, out); a_stack: (n, d, r); b_stack: (n, r, out);
    adapter_idx: (T,) int32.  Returns (T, out)."""
    base = x @ w
    delta = torch.zeros_like(base)
    for i in range(1, a_stack.shape[0]):
        sel = (adapter_idx == i)[:, None].to(x.dtype)
        delta = delta + ((x * sel) @ a_stack[i]) @ b_stack[i]
    return base + delta


def _check(x, w, a_stack, b_stack, adapter_idx):
    named = (("x", x), ("w", w), ("a_stack", a_stack), ("b_stack", b_stack),
             ("adapter_idx", adapter_idx))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: the kernel takes float32 or "
                        "bfloat16")
    for name, t in named[1:4]:
        if t.dtype != x.dtype:
            raise TypeError(f"{name} dtype {t.dtype} differs from x's "
                            f"{x.dtype}")
    if adapter_idx.dtype != torch.int32:
        raise TypeError(f"adapter_idx must be int32, got {adapter_idx.dtype}")
    if x.dim() != 2 or w.dim() != 2 or a_stack.dim() != 3 \
            or b_stack.dim() != 3:
        raise ValueError("expected x (T,d), w (d,out), a_stack (n,d,r) and "
                         "b_stack (n,r,out)")
    T, d = x.shape
    out_dim = w.shape[1]
    n, _, r = a_stack.shape
    if w.shape[0] != d or a_stack.shape[1] != d \
            or b_stack.shape != (n, r, out_dim) or adapter_idx.shape != (T,):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, a_stack {tuple(a_stack.shape)}, "
                         f"b_stack {tuple(b_stack.shape)}, adapter_idx "
                         f"{tuple(adapter_idx.shape)}")
    if d % _ALIGN or out_dim % _ALIGN:
        raise ValueError(f"the kernel takes d and out multiples of {_ALIGN}, "
                         f"got d={d}, out={out_dim}")
    if not 0 < r <= _MAX_RANK:
        raise ValueError(f"rank {r} outside the kernel's 1..{_MAX_RANK}")


def alora_qkv(x: torch.Tensor, w: torch.Tensor, a_stack: torch.Tensor,
              b_stack: torch.Tensor, adapter_idx: torch.Tensor) -> torch.Tensor:
    """Shapes as in :func:`alora_qkv_ref`.  On a CUDA tensor the kernel
    runs: fp32 accumulation, ``x @ A`` rounded once to x's dtype (as the
    TPU kernel does), the output rounded once; d and the output width
    multiples of 8, rank at most 256.  On a CPU tensor the plain version
    does."""
    if x.device.type == "cpu":
        return alora_qkv_ref(x, w, a_stack, b_stack, adapter_idx)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, w, a_stack, b_stack, adapter_idx)
    T, d = x.shape
    out_dim = w.shape[1]
    n, _, r = a_stack.shape
    out = torch.empty((T, out_dim), dtype=x.dtype, device=x.device)
    if T == 0 or out_dim == 0:
        return out
    rp = -(-r // _RANK_PAD) * _RANK_PAD
    xa = torch.empty((T, rp), dtype=x.dtype, device=x.device)
    lib = build.load()
    err = lib.alora_qkv(
        x.data_ptr(), w.data_ptr(), a_stack.data_ptr(), b_stack.data_ptr(),
        adapter_idx.data_ptr(), xa.data_ptr(), out.data_ptr(), T, d, out_dim,
        n, r, rp, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "alora_qkv")
    alora_qkv.launches += 1
    return out


alora_qkv.launches = 0
