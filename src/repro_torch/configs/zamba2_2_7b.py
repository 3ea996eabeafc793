"""zamba2-2.7b — hybrid Mamba2 + shared attention blocks, as the
reference states it (``repro/configs/zamba2_2_7b.py``).
[arXiv:2411.15242]

54 layers, d_model 2560, 32 heads (MHA, kv 32) of 80 in the attention
blocks, d_ff 10240, vocab 32000, SSM state 64.  The stack is Mamba2
blocks with an attention(+MLP) block every 6th layer (the paper's shared
attention block, unrolled).
"""
from repro_torch.configs.base import ATTN, SSM, ModelConfig, SSMConfig

_PATTERN = tuple(ATTN if (i % 6) == 5 else SSM for i in range(54))

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    activation="swiglu",
    layer_pattern=_PATTERN,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk_size=256,
                  conv_width=4, ngroups=1),
    source="arXiv:2411.15242",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="zamba2-2.7b-reduced",
        num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
        head_dim=32, d_ff=256, vocab_size=512, max_seq_len=1024,
        layer_pattern=(SSM, SSM, ATTN, SSM),
        ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, chunk_size=64,
                      conv_width=4, ngroups=1),
        dtype="float32",
    )
