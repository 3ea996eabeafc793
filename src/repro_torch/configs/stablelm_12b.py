"""stablelm-12b — dense GQA decoder, as the reference states it
(``repro/configs/stablelm_12b.py``).  [hf:stabilityai/stablelm-2-1_6b
family]

40 layers, d_model 5120, 32 heads (GQA, kv 8) of 160, d_ff 13824,
vocab 100352, swiglu, untied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    activation="swiglu",
    rope_theta=10_000.0,
    source="hf:stabilityai/stablelm-2-1_6b (scaled family member)",
)


def reduced() -> ModelConfig:
    """2-layer, d<=512 smoke variant of the same (dense GQA swiglu) family."""
    return CONFIG.replace(
        name="stablelm-12b-reduced",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        head_dim=32, d_ff=512, vocab_size=512, max_seq_len=1024,
        dtype="float32",
    )
