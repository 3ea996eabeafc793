"""Tracing and telemetry for the port: ``repro_torch.obs.tracer`` is the
hot-path-safe recording core (plain-Python appends only);
``repro_torch.obs.export`` renders the recorded rings into Perfetto
JSON, Prometheus text and JSONL off the step path."""
from repro_torch.obs.export import (
    d2h_summary,
    prometheus_text,
    reuse_by_adapter,
    to_perfetto,
    trace_records,
    write_jsonl,
    write_perfetto,
)
from repro_torch.obs.tracer import (
    TRACE_RING_KEEP,
    TRACE_RING_MAX,
    Tracer,
    trace_enabled_default,
)

__all__ = [
    "TRACE_RING_KEEP",
    "TRACE_RING_MAX",
    "Tracer",
    "d2h_summary",
    "prometheus_text",
    "reuse_by_adapter",
    "to_perfetto",
    "trace_enabled_default",
    "trace_records",
    "write_jsonl",
    "write_perfetto",
]
