"""nemotron-4-15b — dense GQA, squared-ReLU MLP, as the reference
states it (``repro/configs/nemotron_4_15b.py``).  [arXiv:2402.16819]

32 layers, d_model 6144, 48 heads (GQA, kv 8: G = 6) of 128, d_ff
24576, vocab 256000, non-gated squared-ReLU MLP, untied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    arch_type="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    activation="squared_relu",
    rope_theta=10_000.0,
    source="arXiv:2402.16819",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="nemotron-4-15b-reduced",
        num_layers=2, d_model=192, num_heads=6, num_kv_heads=2,
        head_dim=32, d_ff=768, vocab_size=512, max_seq_len=1024,
        dtype="float32",
    )
