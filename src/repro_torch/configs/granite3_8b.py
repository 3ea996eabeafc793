"""granite-3.2-8b — the paper's own evaluation model (Table 1), as the
reference states it (``repro/configs/granite3_8b.py``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3.2-8b",
    arch_type="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    activation="swiglu",
    tie_embeddings=True,
    source="paper Table 1 / hf:ibm-granite/granite-3.2-8b-instruct",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="granite-3.2-8b-reduced",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        head_dim=32, d_ff=512, vocab_size=512, max_seq_len=2048,
        dtype="float32",
    )
