"""The port's tensor-parallel + ZeRO-1 train step (``make_train_step``
under ``Runtime.mesh``) on CPU ranks against the reference's unsharded
``make_train_step``.

Four gloo ranks (``distributed.spawn.launch``) run
``repro_torch.benchmarks.sharded_model.train_case`` on reduced float32
models with the port's weights from a seed (carried to the reference by
``convert.params_to_jax``), one step from zero moments, at (data, model)
= (2, 2) (granite; mamba2, whose one B/C group every model rank holds;
granite-moe with the masked-dense experts, whose aux takes the global
batch's statistics as the reference's does) and (1, 4) (granite's two
K/V heads replicated over four ranks; granite-moe expert-parallel at
capacity factor 32, no drops).  Loss, ce, aux and grad norm within 1e-5;
the updated params (gathered) within 1e-5 of the tree's max, each
moment leaf within 1e-5 of its own max; every rank's params equal to its
slice of the gathered ones (copies on several ranks stay equal)."""
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models import model as JM
from repro.training import optimizer as JO
from repro.training import train_loop as JT
from repro_torch.benchmarks import sharded_model as SM
from repro_torch.common import tree_at, tree_map, tree_paths
from repro_torch.configs import get_reduced
from repro_torch.distributed.sharding import shard_params
from repro_torch.distributed.spawn import launch
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.model import init_params
from repro_torch.training.optimizer import AdamWState, adamw_state_from_jax
from repro_torch.training.train_loop import TrainState, gather_train_states

torch.set_num_threads(1)

TOL = 1e-5
B, S = 4, 16
EP = {"moe_impl": "expert_parallel", "capacity_factor": 32.0}
# name -> (arch, (data, model), Runtime keywords)
CASES = {"granite@2x2": ("granite-3.2-8b", (2, 2), {}),
         "mamba2@2x2": ("mamba2-2.7b", (2, 2), {}),
         "granite-moe@2x2": ("granite-moe-1b-a400m", (2, 2), {}),
         "granite@1x4": ("granite-3.2-8b", (1, 4), {}),
         "granite-moe-ep@1x4": ("granite-moe-1b-a400m", (1, 4), EP)}


@functools.lru_cache(maxsize=None)
def setup(arch):
    cfg = get_reduced(arch)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.RandomState(1)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)),
             "labels": rng.randint(0, cfg.vocab_size, (B, S)),
             "mask": (rng.rand(B, S) > 0.2).astype(np.float32)}
    return cfg, params, batch


@pytest.fixture(scope="module")
def ranks():
    """The world's per-rank results, run in a background thread while the
    tests compute the reference's steps."""
    cases = [(name, "train", setup(arch),
              dict(mesh=mesh, rt_kw=kw))
             for name, (arch, mesh, kw) in CASES.items()]
    out = {}

    def run():
        try:
            out["res"] = launch(SM.run_cases, cases, data=2, model=2,
                                device="cpu", timeout=300)
        except Exception as e:          # reported by the test that reads it
            out["res"] = e
    th = threading.Thread(target=run)
    th.start()

    def get(name):
        th.join(timeout=600)
        if isinstance(out["res"], Exception):
            raise out["res"]
        return [r[name] for r in out["res"]]
    yield get
    th.join(timeout=600)


@functools.lru_cache(maxsize=None)
def oracle(arch, ep: bool):
    cfg, params, batch = setup(arch)
    cfg_j = jax_reduced(arch)
    rt = JM.Runtime(mesh=jax_host_mesh(), batch_axes=("data",), **EP) \
        if ep else JM.Runtime()
    jp = jax.tree.map(jnp.asarray, params_to_jax(params, cfg))
    js, stats = jax.jit(JT.make_train_step(
        cfg_j, JO.AdamWConfig(total_steps=10), rt, loss_chunk=16))(
        JT.init_train_state(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    want = TrainState(
        params_from_jax(jax.tree.map(np.asarray, js.params), cfg, "cpu"),
        adamw_state_from_jax(jax.tree.map(np.asarray, js.opt), cfg, "cpu"))
    return want, {k: float(v) for k, v in stats.items()}


def tensors(tree):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def rel(got, want) -> float:
    return float((got - want).abs().max() / max(float(want.abs().max()),
                                                 1e-30))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_train_step_matches_reference(ranks, name):
    arch, (data, model), kw = CASES[name]
    cfg = setup(arch)[0]
    want, wstats = oracle(arch, bool(kw))
    res = ranks(name)
    for r in res:
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            assert abs(r["stats"][k] - wstats[k]) <= \
                TOL * max(abs(wstats[k]), 1e-6), (k, r["stats"][k], wstats[k])
    if cfg.moe is not None:
        assert wstats["aux"] > 0
    states = [TrainState(tensors(r["params"]), AdamWState(
        torch.tensor(r["step"]), tensors(r["mu"]), tensors(r["nu"])))
        for r in res]
    got = gather_train_states(states, cfg, {"data": data, "model": model})
    scale = max(float(t.abs().max()) for _, t in tree_paths(want.params))
    for path, a in tree_paths(got.params):
        assert float((a - tree_at(want.params, path)).abs().max()) \
            <= TOL * scale, path
    for tree, ref in ((got.opt.mu, want.opt.mu), (got.opt.nu, want.opt.nu)):
        for path, a in tree_paths(tree):
            assert rel(a, tree_at(ref, path)) < TOL, path
    # every rank's params are exactly its slice of the gathered ones
    sizes = {"data": data, "model": model}
    for rank, st in enumerate(states):
        coords = {"data": rank // model, "model": rank % model}
        mine = shard_params(got.params, cfg, sizes, coords)
        for path, a in tree_paths(st.params):
            assert torch.equal(a, tree_at(mine, path)), (rank, path)
    # gradients summed over data, the replicated K/V heads' over model,
    # the norm's partial sums over model, ZeRO-1's blocks gathered
    coll = res[0]["collectives"]
    assert coll["all-gather"]["count"] >= (1 if data > 1 else 0) + 1
    assert coll["all-reduce"]["count"] > 0
