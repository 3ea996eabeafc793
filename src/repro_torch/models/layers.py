"""Shared building blocks, the PyTorch counterparts of the reference's
``repro/models/layers.py``.

Plain functions on tensors with explicit parameter dictionaries.  The
rounding points follow the reference exactly: ``rmsnorm`` and
``apply_rope`` compute in fp32 and cast back, and ``qkv_project`` adds
the adapter delta in the activation dtype.  Dense products are
``torch.matmul``, as the reference leaves them to XLA.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ragged_lora import ragged_grouped_lora

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def padded_vocab(cfg: ModelConfig, multiple: int = 512) -> int:
    """Vocab rounded up to ``multiple`` (the reference's embedding and
    logit width; tied logits span every padded row)."""
    v = cfg.vocab_size
    return ((v + multiple - 1) // multiple) * multiple


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    orig = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * w.float()).to(orig)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs        # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp_apply(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation != "swiglu":
        raise NotImplementedError(
            f"activation {cfg.activation!r} is not ported yet (ROADMAP A10)")
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens]


def unembed(p: Params, x: torch.Tensor, tie: bool) -> torch.Tensor:
    if tie:
        return x @ p["tok"].T
    return x @ p["unembed"]


def lora_delta(x: torch.Tensor, a_stack: torch.Tensor, b_stack: torch.Tensor,
               adapter_idx: torch.Tensor) -> torch.Tensor:
    """Dense multi-adapter low-rank delta with activation-aware masking
    (paper Alg. 1): every slot 1..n-1 of the stack is applied to the
    tokens whose adapter index selects it.  The equivalence oracle of the
    grouped kernel.

    x: (..., T, d); a_stack: (n, d, r), slot 0 zero; b_stack: (n, r, out);
    adapter_idx: (..., T) int.  Returns (..., T, out) in x's dtype."""
    acc = torch.zeros(x.shape[:-1] + (b_stack.shape[-1],), dtype=x.dtype,
                      device=x.device)
    for i in range(1, a_stack.shape[0]):
        sel = (adapter_idx == i)[..., None].to(x.dtype)
        acc = acc + ((x * sel) @ a_stack[i]) @ b_stack[i]
    return acc


def lora_delta_dispatch(x: torch.Tensor, a_stack: torch.Tensor,
                        b_stack: torch.Tensor, adapter_idx: torch.Tensor,
                        active_slots: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The dense delta when ``active_slots`` is None, else the grouped
    delta over the step's active slots (the mixed serving step): the
    hand-written kernel on a CUDA tensor, its plain version on the CPU.

    The two agree within rounding, not bitwise: the dense delta sums over
    a different contraction length per slot than the grouped one."""
    if active_slots is None:
        return lora_delta(x, a_stack, b_stack, adapter_idx)
    lead = x.shape[:-1]
    d = ragged_grouped_lora(x.reshape(-1, x.shape[-1]).contiguous(),
                            a_stack, b_stack,
                            adapter_idx.reshape(-1).contiguous(),
                            active_slots)
    return d.reshape(lead + (d.shape[-1],))


def qkv_project(p: Params, cfg: ModelConfig, x: torch.Tensor,
                alora: Optional[Params] = None,
                adapter_idx: Optional[torch.Tensor] = None, *,
                active_slots: Optional[torch.Tensor] = None):
    """Project to q, k, v, adding the activation-aware low-rank update of
    each of Q/K/V when ``alora`` ({"aq","bq","ak","bk","av","bv"} with a
    leading slot axis) is given."""
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if alora is not None:
        if adapter_idx is None:
            raise ValueError("alora weights given without adapter_idx")
        q = q + lora_delta_dispatch(x, alora["aq"], alora["bq"],
                                    adapter_idx, active_slots)
        k = k + lora_delta_dispatch(x, alora["ak"], alora["bk"],
                                    adapter_idx, active_slots)
        v = v + lora_delta_dispatch(x, alora["av"], alora["bv"],
                                    adapter_idx, active_slots)
    lead = x.shape[:-1]
    q = q.reshape(lead + (cfg.num_heads, cfg.head_dim))
    k = k.reshape(lead + (cfg.num_kv_heads, cfg.head_dim))
    v = v.reshape(lead + (cfg.num_kv_heads, cfg.head_dim))
    return q, k, v


def out_project(p: Params, cfg: ModelConfig, attn_out: torch.Tensor
                ) -> torch.Tensor:
    lead = attn_out.shape[:-2]
    return attn_out.reshape(lead + (-1,)) @ p["wo"]
