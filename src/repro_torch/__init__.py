"""PyTorch/CUDA port of the multi-adapter aLoRA serving system.

A second package beside the JAX reference (``repro``), with the same
module layout.  It imports torch and numpy, never jax and nothing of
``repro``.  Entry points run on the card unless the caller passes
``device="cpu"``, which runs every kernel's plain PyTorch version.
"""
