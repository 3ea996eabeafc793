"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version beside it (``paged_attention``, ``ragged_lora``, ``ssd_chunk``);
``build`` compiles and loads them."""
