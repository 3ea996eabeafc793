"""Architecture registry of the port: every configuration of the
reference's ``repro.configs``, its assigned input shapes and the
assigned pool of architectures (every one but the paper's own
granite-3.2-8b)."""
from __future__ import annotations

from repro_torch.configs import (granite3_8b, granite_moe_1b, mamba2_2_7b,
                                  minitron_4b, nemotron_4_15b, phi3_5_moe,
                                  phi3_vision_4_2b, stablelm_12b,
                                  starcoder2_3b, whisper_large_v3,
                                  zamba2_2_7b)
from repro_torch.configs.base import (ATTN, INPUT_SHAPES,  # noqa: F401
                                      SSM, InputShape, ModelConfig)

_MODULES = {"granite-3.2-8b": granite3_8b, "mamba2-2.7b": mamba2_2_7b,
            "zamba2-2.7b": zamba2_2_7b, "stablelm-12b": stablelm_12b,
            "minitron-4b": minitron_4b, "nemotron-4-15b": nemotron_4_15b,
            "starcoder2-3b": starcoder2_3b,
            "granite-moe-1b-a400m": granite_moe_1b,
            "phi3.5-moe-42b-a6.6b": phi3_5_moe,
            "phi-3-vision-4.2b": phi3_vision_4_2b,
            "whisper-large-v3": whisper_large_v3}
# the reference's order of the assigned pool
ASSIGNED_ARCHS = ["stablelm-12b", "nemotron-4-15b", "mamba2-2.7b",
                  "starcoder2-3b", "whisper-large-v3", "phi3.5-moe-42b-a6.6b",
                  "minitron-4b", "zamba2-2.7b", "phi-3-vision-4.2b",
                  "granite-moe-1b-a400m"]


def _module(arch_id: str):
    if arch_id in _MODULES:
        return _MODULES[arch_id]
    raise KeyError(f"unknown arch {arch_id!r}; choose from {sorted(_MODULES)}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).reduced()


def list_archs() -> list:
    """Every registered architecture id."""
    return list(_MODULES)


def get_input_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
