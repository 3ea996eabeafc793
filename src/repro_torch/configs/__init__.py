"""Architecture registry of the port.

Only the configurations whose path the port runs are registered; every
other architecture of the reference raises and names the ROADMAP item
that ports it.
"""
from __future__ import annotations

from repro_torch.configs import granite3_8b, mamba2_2_7b, zamba2_2_7b
from repro_torch.configs.base import ATTN, SSM, ModelConfig  # noqa: F401

_MODULES = {"granite-3.2-8b": granite3_8b, "mamba2-2.7b": mamba2_2_7b,
            "zamba2-2.7b": zamba2_2_7b}

# reference architectures still to be ported -> ROADMAP queue A item
_NOT_PORTED = {
    "whisper-large-v3": "A10", "phi3.5-moe-42b-a6.6b": "A10",
    "granite-moe-1b-a400m": "A10", "phi-3-vision-4.2b": "A10",
    "starcoder2-3b": "A10", "stablelm-12b": "A10",
    "nemotron-4-15b": "A10", "minitron-4b": "A10",
}


def _module(arch_id: str):
    if arch_id in _MODULES:
        return _MODULES[arch_id]
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id!r} is not ported to repro_torch yet "
            f"(ROADMAP queue A item {_NOT_PORTED[arch_id]})")
    raise KeyError(f"unknown arch {arch_id!r}; choose from {sorted(_MODULES)}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).reduced()
