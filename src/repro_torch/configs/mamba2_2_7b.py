"""mamba2-2.7b — pure SSM (SSD, state-space duality), as the reference
states it (``repro/configs/mamba2_2_7b.py``).  [arXiv:2405.21060]

64 layers, d_model 2560 (attention-free), vocab 50280, SSM state 128.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=1,           # unused for pure-SSM stacks
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=256,
                  conv_width=4, ngroups=1),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="mamba2-2.7b-reduced",
        num_layers=2, d_model=128, vocab_size=512, max_seq_len=1024,
        ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, chunk_size=64,
                      conv_width=4, ngroups=1),
        dtype="float32",
    )
