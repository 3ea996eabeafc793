"""The reference's ``examples/`` on the port, each a module with a
``main(device=...)``: ``quickstart`` (cross-model KV reuse in one
base → aLoRA turn), ``serve_multiturn`` (batched base → adapter → base
conversations, LoRA against aLoRA) and ``async_poisson`` (Poisson
arrivals, continuous batching).  Run one with
``python -m repro_torch.examples.quickstart`` (on the card;
``--device cpu`` for the plain versions)."""
