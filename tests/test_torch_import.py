"""The port's package rules: ``repro_torch`` (and ``chip_smoke.py``)
import neither jax nor the JAX package, entry points default to the card
and raise without one, and unported families raise naming their ROADMAP
item."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import MoEConfig
from repro_torch.core.alora import init_adapter_weights
from repro_torch.models.model import check_supported, init_params
from repro_torch.serving import Engine, EngineConfig
from repro_torch.serving.adapter_pool import AdapterPool
from repro_torch.serving.runner import ModelRunner, RunnerConfig

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
# the SSM slice's modules, which the import guard must load
NEW_MODULES = ("repro_torch.configs.mamba2_2_7b",
               "repro_torch.configs.zamba2_2_7b",
               "repro_torch.kernels.ssd_chunk", "repro_torch.models.ssm")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


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
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        f"missing = set({NEW_MODULES!r}) - set(names)\n"
        "assert not missing, missing\n"
        "assert len(names) >= 24, names\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


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


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def small():
    cfg = get_reduced("granite-3.2-8b")
    return cfg, init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")


@pytest.mark.parametrize("entry", ["engine", "runner", "pool",
                                   "init_params", "init_adapter"])
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
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_sequential_mode_raises_naming_roadmap_item(small):
    cfg, params = small
    with pytest.raises(NotImplementedError, match="A11"):
        Engine(cfg, params, device="cpu",
               engine_cfg=EngineConfig(execution_mode="sequential"))


@pytest.mark.parametrize("arch,item", [("starcoder2-3b", "A10"),
                                       ("granite-moe-1b-a400m", "A10"),
                                       ("whisper-large-v3", "A10"),
                                       ("phi3.5-moe-42b-a6.6b", "A10")])
def test_unported_configs_raise_naming_roadmap_item(arch, item):
    with pytest.raises(NotImplementedError, match=item):
        get_config(arch)


@pytest.mark.parametrize("kw,item", [
    ({"moe": MoEConfig(num_experts=4, experts_per_token=2, d_ff=64)},
     "A10"),
    ({"is_encoder_decoder": True}, "A10"),
    ({"frontend": "vision"}, "A10"),
    ({"sliding_window": 64}, "A10")])
def test_unported_families_raise_at_construction(kw, item):
    cfg = get_reduced("granite-3.2-8b").replace(**kw)
    with pytest.raises(NotImplementedError, match=item):
        check_supported(cfg)


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
