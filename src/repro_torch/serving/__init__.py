"""The serving engine of the port: paged KV cache, cross-model prefix
reuse, aLoRA and the paged adapter-slot pool.  The multi-replica router
is ``repro_torch.serving.router``."""
from repro_torch.serving.adapter_pool import AdapterPool
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.metrics import (AdapterPoolStats, MetricsAggregate,
                                         aggregate, fmt_speedups,
                                         speedup_table)
from repro_torch.serving.request import Request, State
from repro_torch.serving.runner import ModelRunner, RunnerConfig

__all__ = [
    "AdapterPool", "AdapterPoolStats", "Engine", "EngineConfig",
    "MetricsAggregate", "ModelRunner", "Request", "RunnerConfig", "State",
    "aggregate", "fmt_speedups", "speedup_table",
]
