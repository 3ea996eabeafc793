"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version beside it (``paged_attention``, ``ragged_lora``, ``ssd_chunk``,
``alora_qkv``); ``build`` compiles and loads them, ``bench`` times them.

:data:`WRAPPERS` are the mixed step's kernels, whose wrappers count their
launches in ``.launches`` (:func:`launch_counts`)."""
from typing import Dict

from repro_torch.kernels import paged_attention, ragged_lora, ssd_chunk

WRAPPERS = {"ragged_paged_attention": paged_attention.ragged_paged_attention,
            "ragged_grouped_lora_qkv": ragged_lora.ragged_grouped_lora_qkv,
            "ragged_grouped_lora": ragged_lora.ragged_grouped_lora,
            "ragged_ssd_chunk_scan": ssd_chunk.ragged_ssd_chunk_scan}


def launch_counts() -> Dict[str, int]:
    return {k: fn.launches for k, fn in WRAPPERS.items()}
