"""The serving engine of the port: scheduler, runner, adapter pool."""
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: F401
