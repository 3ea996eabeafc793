"""granite-moe-1b-a400m — mixture of experts, 32 experts top-8, as the
reference states it (``repro/configs/granite_moe_1b.py``).
[hf:ibm-granite/granite-3.0-1b-a400m-base]

24 layers, d_model 1024, 16 heads (GQA, kv 8) of 64, per-expert d_ff
512, vocab 49155 (padded to 49,664), swiglu experts, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    activation="swiglu",
    moe=MoEConfig(num_experts=32, experts_per_token=8, d_ff=512),
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="granite-moe-reduced",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=128, vocab_size=512, max_seq_len=1024,
        moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff=128),
        dtype="float32",
    )
