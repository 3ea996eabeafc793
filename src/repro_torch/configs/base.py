"""Model configuration for the PyTorch port.

A copy of the reference package's ``ModelConfig`` (``repro/configs/base.py``)
kept here so the port imports nothing from ``repro``.  The fields and
their defaults are identical, so a config built here describes exactly
the same network as its reference twin.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Layer kinds used in ``layer_pattern`` for hybrid architectures.
ATTN = "attn"
SSM = "ssm"


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings for the MLP sublayer."""

    num_experts: int
    experts_per_token: int
    d_ff: int
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) settings."""

    state_dim: int
    head_dim: int = 64
    expand: int = 2
    chunk_size: int = 256
    conv_width: int = 4
    ngroups: int = 1


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (field for field the reference's)."""

    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    activation: str = "swiglu"     # swiglu | squared_relu | gelu
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    max_seq_len: int = 131_072
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    sliding_window: int = 0
    long_context_window: int = 8192
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    layer_pattern: Optional[Tuple[str, ...]] = None
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0
    frontend: str = "none"         # none | audio | vision
    num_patches: int = 0
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.name}: num_heads={self.num_heads} not a "
                             f"multiple of num_kv_heads={self.num_kv_heads}")
        if self.layer_pattern is not None \
                and len(self.layer_pattern) != self.num_layers:
            raise ValueError(f"{self.name}: layer_pattern length "
                             f"{len(self.layer_pattern)} != num_layers")

    def pattern(self) -> Tuple[str, ...]:
        if self.layer_pattern is not None:
            return self.layer_pattern
        if self.arch_type == "ssm":
            return tuple([SSM] * self.num_layers)
        return tuple([ATTN] * self.num_layers)

    def param_count(self) -> int:
        """Total parameters (embeddings once, tied -> once; an
        encoder-decoder adds its encoder's attention and MLP weights and
        each decoder layer's cross-attention weights; norms counted as
        the reference counts them)."""
        d = self.d_model
        emb = self.vocab_size * d
        n = emb if self.tie_embeddings else 2 * emb
        attn, mlp = self._attn_params(), self._mlp_params()
        for kind in self.pattern():
            n += attn + mlp if kind == ATTN else self._ssm_params()
        if self.is_encoder_decoder:
            n += self.num_encoder_layers * (attn + mlp) \
                + self.num_layers * attn
        n += (self.num_layers * 2 + 1) * d
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: the k routed experts and
        the router in place of every expert; the reference's count)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        n_attn = self.pattern().count(ATTN)
        routed = 3 * self.d_model * m.d_ff * m.experts_per_token \
            + self.d_model * m.num_experts
        return self.param_count() - n_attn * (self._mlp_params() - routed)

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        return d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d

    def _mlp_params(self) -> int:
        """One MLP sublayer: (3 if swiglu else 2) weight matrices, per
        expert and with the router for MoE."""
        gate_mult = 3 if self.activation == "swiglu" else 2
        if self.moe is not None:
            m = self.moe
            return m.num_experts * gate_mult * self.d_model * m.d_ff \
                + self.d_model * m.num_experts
        return gate_mult * self.d_model * self.d_ff

    def _ssm_params(self) -> int:
        s = self.ssm
        d = self.d_model
        d_inner = s.expand * d
        nheads = d_inner // s.head_dim
        # in_z / in_xbc / in_dt, the depthwise conv, out_proj, then
        # A_log, dt_bias, D and the gated norm
        in_proj = d * (2 * d_inner + 2 * s.ngroups * s.state_dim + nheads)
        conv = s.conv_width * (d_inner + 2 * s.ngroups * s.state_dim)
        return in_proj + conv + d_inner * d + nheads * 2 + d_inner

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# The input shapes assigned to the paper (global batch and sequence), the
# reference's ``INPUT_SHAPES``: the dry run's (arch × shape) matrix.
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
