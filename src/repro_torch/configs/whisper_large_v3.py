"""whisper-large-v3 — the audio encoder-decoder backbone, as the
reference states it (``repro/configs/whisper_large_v3.py``).
[arXiv:2212.04356]

32 decoder layers, d_model 1280, 20 heads (MHA, kv 20) of 64, d_ff
5120, vocab 51866, tanh gelu, untied embeddings; a 32-layer
bidirectional encoder over 1500 frames.  The conv/mel frontend is a
stub in the reference too: a request brings its (1500, d_model) frame
embeddings (``Engine.submit(frame_embeds=...)``), and every decoder
layer cross-attends to their projected K/V.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    arch_type="audio",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    activation="gelu",
    is_encoder_decoder=True,
    num_encoder_layers=32,
    encoder_seq_len=1500,
    frontend="audio",
    max_seq_len=1_048_576,
    source="arXiv:2212.04356",
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-large-v3-reduced",
        num_layers=2, num_encoder_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        encoder_seq_len=64, max_seq_len=1024, dtype="float32",
    )
