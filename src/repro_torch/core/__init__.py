"""The paper's contribution in the port: base-aligned block hashing,
activation-aware masking, paged block management, the cross-model
prefix cache and the aLoRA adapter weights."""
from repro_torch.core.activation_mask import (  # noqa: F401
    adapter_index_for_positions,
    find_invocation_start,
)
from repro_torch.core.alora import (  # noqa: F401
    PAPER_ALORA_RANK,
    PAPER_LORA_RANK,
    AdapterSpec,
    adapter_rank_of,
    init_adapter_weights,
    pad_adapter_rank,
    per_layer_adapters,
    stack_adapters,
    zero_adapter_weights,
)
from repro_torch.core.block_hash import (  # noqa: F401
    AdapterKey,
    block_extra,
    hash_block,
    request_block_hashes,
)
from repro_torch.core.kv_manager import BlockManager, OutOfBlocks  # noqa: F401
from repro_torch.core.prefix_cache import MatchResult, PrefixCache  # noqa: F401
