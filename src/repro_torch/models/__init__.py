"""Model building blocks and the dense, SSM and hybrid stack assembly."""
from repro_torch.models.model import (  # noqa: F401
    Runtime,
    decode_step,
    forward_full,
    init_decode_caches,
    init_params,
    iter_layers,
    logits_for,
    period_segments,
    prefill_to_decode_caches,
)
