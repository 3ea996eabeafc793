"""phi-3-vision-4.2b — the phi3-mini backbone of a vision-language
model, as the reference states it (``repro/configs/phi3_vision_4_2b.py``).
[hf:microsoft/Phi-3-vision-128k-instruct]

32 layers, d_model 3072, 32 heads (MHA, kv 32) of 96, d_ff 8192, vocab
32064, swiglu, untied embeddings.  The CLIP encoder and projector are a
stub in the reference too: a request brings its ``num_patches`` patch
embeddings (``Engine.submit(prefix_embeds=...)``), which take the place
of the prompt's leading rows, so their KV blocks are reused across
models like any text block (salted with the image's digest).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    activation="swiglu",
    rope_theta=10_000.0,
    frontend="vision",
    num_patches=576,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="phi-3-vision-reduced",
        num_layers=2, d_model=256, num_heads=8, num_kv_heads=8,
        head_dim=32, d_ff=512, vocab_size=512, num_patches=16,
        max_seq_len=1024, dtype="float32",
    )
