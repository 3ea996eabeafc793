"""The port's package rules: ``repro_torch`` (and ``chip_smoke.py``)
import neither jax nor the JAX package nor its benchmarks, every
configuration of the reference is registered, and entry points default
to the card and raise without one."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.alora import init_adapter_weights
from repro_torch.launch import serve
from repro_torch.models.model import check_supported, init_params
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.adapter_pool import AdapterPool
from repro_torch.serving.runner import ModelRunner, RunnerConfig

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
# the modules of the later slices, which the import guard must
# load
NEW_MODULES = ("repro_torch.configs.mamba2_2_7b",
               "repro_torch.configs.zamba2_2_7b",
               "repro_torch.kernels.ssd_chunk", "repro_torch.models.ssm",
               "repro_torch.kernels.alora_qkv", "repro_torch.kernels.bench",
               "repro_torch.models.moe", "repro_torch.configs.phi3_5_moe",
               "repro_torch.configs.granite_moe_1b",
               "repro_torch.configs.phi3_vision_4_2b",
               "repro_torch.configs.whisper_large_v3",
               "repro_torch.serving.router", "repro_torch.obs.export",
               "repro_torch.launch", "repro_torch.launch.serve",
               "repro_torch.analysis", "repro_torch.analysis.__main__",
               "repro_torch.analysis.hotpath_lint",
               "repro_torch.analysis.lifecycle_check",
               "repro_torch.analysis.step_audit",
               "repro_torch.analysis.step_trace",
               "repro_torch.benchmarks", "repro_torch.benchmarks.common",
               "repro_torch.benchmarks.bench_adapter_base",
               "repro_torch.benchmarks.bench_async",
               "repro_torch.benchmarks.bench_batch_size",
               "repro_torch.benchmarks.bench_generation_length",
               "repro_torch.benchmarks.bench_mixed_batch",
               "repro_torch.benchmarks.bench_multi_adapter",
               "repro_torch.benchmarks.bench_prompt_length",
               "repro_torch.benchmarks.bench_router",
               "repro_torch.benchmarks.run", "repro_torch.examples",
               "repro_torch.examples.quickstart",
               "repro_torch.examples.serve_multiturn",
               "repro_torch.examples.async_poisson",
               "repro_torch.training", "repro_torch.training.data",
               "repro_torch.training.optimizer",
               "repro_torch.training.train_loop",
               "repro_torch.training.checkpoint",
               "repro_torch.launch.train",
               "repro_torch.examples.train_small")


FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_import_loads_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import importlib.util as u\n"
        f"spec = u.spec_from_file_location('chip_smoke', "
        f"{str(ROOT / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(u.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        f"missing = set({NEW_MODULES!r}) - set(names)\n"
        "assert not missing, missing\n"
        "assert len(names) >= 30, names\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # importing ran no entry point (__main__, the benches, the examples)
    assert out.stdout == "", out.stdout


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_source_imports_no_jax_or_repro(path):
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert not [n for n in names if _forbidden(n)]


MODEL_FILES = sorted((ROOT / "src" / "repro_torch" / "models").glob("*.py"))


@pytest.mark.parametrize("path", MODEL_FILES,
                         ids=[p.name for p in MODEL_FILES])
def test_model_layer_imports_nothing_of_training(path):
    """The model layer sits below training: ``repro_torch.models`` never
    imports ``repro_torch.training``."""
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert not [n for n in names if n.startswith("repro_torch.training")]


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def small():
    cfg = get_reduced("granite-3.2-8b")
    return cfg, init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")


@pytest.mark.parametrize("entry", ["engine", "runner", "pool",
                                   "init_params", "init_adapter",
                                   "build_engine", "launcher_adapters"])
def test_entry_points_default_to_cuda_and_raise_without_it(
        small, monkeypatch, entry):
    cfg, params = small
    _no_cuda(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    calls = {
        "engine": lambda: Engine(cfg, params),
        "runner": lambda: ModelRunner(cfg, params, RunnerConfig()),
        "pool": lambda: AdapterPool(cfg, num_slots=1, slot_rank=8),
        "init_params": lambda: init_params(gen, cfg),
        "init_adapter": lambda: init_adapter_weights(gen, cfg, 8),
        "build_engine": lambda: serve.build_engine(cfg, params, [],
                                                   replicas=2),
        "launcher_adapters": lambda: serve.init_adapters(gen, cfg, "alora"),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_sequential_engine_defaults_to_cuda_and_raises_without_it(
        small, monkeypatch):
    cfg, params = small
    Engine(cfg, params, device="cpu",
           engine_cfg=EngineConfig(execution_mode="sequential"))
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params,
               engine_cfg=EngineConfig(execution_mode="sequential"))


def test_unknown_execution_mode_raises(small):
    cfg, params = small
    with pytest.raises(ValueError, match="execution_mode"):
        Engine(cfg, params, device="cpu",
               engine_cfg=EngineConfig(execution_mode="pipelined"))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_whisper_config_is_registered(reduced):
    cfg = (get_reduced if reduced else get_config)("whisper-large-v3")
    assert cfg.is_encoder_decoder and cfg.frontend == "audio"
    check_supported(cfg)


@pytest.fixture(scope="module")
def whisper():
    cfg = get_reduced("whisper-large-v3")
    return cfg, init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")


@pytest.mark.parametrize("entry", ["engine", "sequential", "runner",
                                   "init_params"])
def test_whisper_entry_points_default_to_cuda_and_raise_without_it(
        whisper, monkeypatch, entry):
    cfg, params = whisper
    _no_cuda(monkeypatch)
    calls = {
        "engine": lambda: Engine(cfg, params),
        "sequential": lambda: Engine(
            cfg, params, engine_cfg=EngineConfig(execution_mode="sequential")),
        "runner": lambda: ModelRunner(cfg, params, RunnerConfig()),
        "init_params": lambda: init_params(torch.Generator().manual_seed(0),
                                           cfg),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_encoder_decoder_needs_encoder_layers_and_frames():
    cfg = get_reduced("whisper-large-v3").replace(num_encoder_layers=0)
    with pytest.raises(ValueError, match="encoder"):
        check_supported(cfg)
    eng = Engine(get_reduced("whisper-large-v3"),
                 init_params(torch.Generator().manual_seed(0),
                             get_reduced("whisper-large-v3"), device="cpu"),
                 device="cpu")
    with pytest.raises(ValueError, match="frame_embeds"):
        eng.submit([1, 2, 3], 2)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "phi3.5-moe-42b-a6.6b",
                                  "phi-3-vision-4.2b"])
def test_moe_and_vision_configs_are_registered(arch):
    cfg = get_config(arch)
    assert cfg.name == arch
    check_supported(cfg)
    check_supported(get_reduced(arch))


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "phi-3-vision-4.2b"])
def test_moe_and_vision_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, arch):
    cfg = get_reduced(arch)
    params = init_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params)


def test_ssm_stack_without_ssm_config_raises():
    cfg = get_reduced("granite-3.2-8b").replace(arch_type="ssm")
    with pytest.raises(ValueError, match="SSMConfig"):
        check_supported(cfg)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, arch):
    cfg = get_reduced(arch)
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(torch.Generator().manual_seed(0), cfg)


@pytest.mark.parametrize("entry", ["launch_train", "train_small",
                                   "init_decode_caches"])
def test_training_entry_points_default_to_cuda_and_raise_without_it(
        small, monkeypatch, entry):
    from repro_torch.examples import train_small
    from repro_torch.launch import train
    from repro_torch.models.model import init_decode_caches
    cfg, _ = small
    _no_cuda(monkeypatch)
    calls = {
        "launch_train": lambda: train.main(["--steps", "1"]),
        "train_small": lambda: train_small.main(),
        "init_decode_caches": lambda: init_decode_caches(cfg, 1, 8),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
