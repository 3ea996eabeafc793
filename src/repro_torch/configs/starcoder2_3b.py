"""starcoder2-3b — dense GQA with native sliding-window attention, as
the reference states it (``repro/configs/starcoder2_3b.py``).
[arXiv:2402.19173]

30 layers, d_model 3072, 24 heads (GQA, kv 2: G = 12) of 128, d_ff
12288, vocab 49152, non-gated tanh-GELU MLP, window 4096, untied
embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    arch_type="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    activation="gelu",
    rope_theta=999_999.0,
    sliding_window=4096,       # model-card native window
    source="arXiv:2402.19173",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="starcoder2-3b-reduced",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        head_dim=32, d_ff=512, vocab_size=512, max_seq_len=1024,
        sliding_window=128, dtype="float32",
    )
