"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version beside it (``paged_attention``, ``ragged_lora``); ``build``
compiles and loads them."""
