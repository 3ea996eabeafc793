"""The paper's serving benchmarks on the port — counterparts of the
reference's ``benchmarks/`` folder, one module each, with the same
``name,us_per_call,derived`` CSV rows.  Run one section or all with
``python -m repro_torch.benchmarks.run [section ...]``, or a module
alone (``python -m repro_torch.benchmarks.bench_mixed_batch --smoke``).
They run on the card; ``--device cpu`` runs every kernel's plain
PyTorch version."""
