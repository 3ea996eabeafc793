"""Tracing for the port (a copy of the reference's recorder)."""
from repro_torch.obs.tracer import Tracer  # noqa: F401
