"""minitron-4b — pruned nemotron (dense GQA, squared-ReLU), as the
reference states it (``repro/configs/minitron_4b.py``).
[arXiv:2407.14679]

32 layers, d_model 3072, 24 heads (GQA, kv 8: G = 3) of 128, d_ff 9216,
vocab 256000, non-gated squared-ReLU MLP, untied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    activation="squared_relu",
    rope_theta=10_000.0,
    source="arXiv:2407.14679",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="minitron-4b-reduced",
        num_layers=2, d_model=192, num_heads=6, num_kv_heads=2,
        head_dim=32, d_ff=384, vocab_size=512, max_seq_len=1024,
        dtype="float32",
    )
