"""phi3.5-moe-42b-a6.6b — mixture of experts, 16 experts top-2, as the
reference states it (``repro/configs/phi3_5_moe.py``).
[hf:microsoft/Phi-3.5-MoE-instruct]

32 layers, d_model 4096, 32 heads (GQA, kv 8) of 128, per-expert d_ff
6400, vocab 32064, swiglu experts, untied embeddings.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    activation="swiglu",
    moe=MoEConfig(num_experts=16, experts_per_token=2, d_ff=6400),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="phi3.5-moe-reduced",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, max_seq_len=1024,
        moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff=256),
        dtype="float32",
    )
