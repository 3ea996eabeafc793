"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe`` on the reduced granite-moe and phi3.5-moe with
converted weights, float32, and the port's config arithmetic against
the reference's for every registered configuration.

Tolerances: the router's weights and aux loss within 1e-6 (float32
logits of a 128/256-wide product, summed in different orders), its
expert indices equal wherever the row's top-k margin (k-th gate minus
the (k+1)-th) exceeds 1e-5; the layer and the MoE sublayer within 1e-5
of max |reference| (the experts' outputs are summed in one reduction
here and one after another there)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch.configs import _MODULES, get_config, get_reduced
from repro_torch.models import model as M
from repro_torch.models import moe as MoE
from repro_torch.models.convert import params_from_jax

# one intra-op thread: this file shares the CPU with the rest of the suite
torch.set_num_threads(1)

ARCHS = ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"]


@pytest.fixture(scope="module", params=ARCHS, ids=["granite_moe", "phi35_moe"])
def setup(request):
    arch = request.param
    cfg_j, cfg = jax_reduced(arch), get_reduced(arch)
    pj = JM.init_params(jax.random.key(0), cfg_j)
    params = params_from_jax(jax.tree.map(np.asarray, pj), cfg, "cpu")
    jlayers = [lp for _, lp in JM.iter_layers(pj, cfg_j)]
    return dict(cfg=cfg, cfg_j=cfg_j, params=params, jlayers=jlayers)


def _x(*shape, seed=0):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(got.numpy() - want).max() / np.abs(want).max()


def test_converted_moe_weights_keep_dtypes_and_values(setup):
    """``params_from_jax`` carries ``moe/router`` as float32 and the
    expert stacks unchanged, one MoE subtree per layer and no ``mlp``."""
    cfg = setup["cfg"]
    for lp, jl in zip(setup["params"]["layers"], setup["jlayers"]):
        assert "mlp" not in lp and set(lp["moe"]) == set(jl["moe"])
        assert lp["moe"]["router"].dtype == torch.float32
        for k, v in jl["moe"].items():
            np.testing.assert_array_equal(lp["moe"][k].numpy(),
                                          np.asarray(v))
        E, f = cfg.moe.num_experts, cfg.moe.d_ff
        assert lp["moe"]["w_up"].shape == (E, cfg.d_model, f)
        assert lp["moe"]["w_down"].shape == (E, f, cfg.d_model)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_moe_shapes_and_dtypes_match_reference(setup, dtype):
    cfg, cfg_j = setup["cfg"], setup["cfg_j"]
    mine = MoE.init_moe(torch.Generator().manual_seed(0), cfg,
                        getattr(torch, dtype), "cpu")
    ref = JMoE.init_moe(jax.random.key(1), cfg_j, getattr(jnp, dtype))
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in mine.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in ref.items()}
    # the reference's standard deviations: 0.02, and 0.02 / sqrt(2 L) out
    out_std = 0.02 / np.sqrt(2 * cfg.num_layers)
    for k, sd in (("router", 0.02), ("w_up", 0.02), ("w_down", out_std)):
        assert abs(mine[k].float().std().item() - sd) < 0.05 * sd, k


def test_init_params_gives_moe_layers(setup):
    cfg = setup["cfg"]
    mine = M.init_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    for a, b in zip(mine["layers"], setup["params"]["layers"]):
        assert set(a) == set(b)
        assert {k: v.shape for k, v in a["moe"].items()} == \
            {k: v.shape for k, v in b["moe"].items()}


def _margin(gates, k):
    top = np.sort(gates, axis=-1)[..., ::-1]
    return top[..., k - 1] - top[..., k]


def test_route_matches_reference(setup):
    cfg, cfg_j = setup["cfg"], setup["cfg_j"]
    k = cfg.moe.experts_per_token
    for lp, jl in zip(setup["params"]["layers"], setup["jlayers"]):
        jx, tx = _x(3, 40, cfg.d_model, seed=1)
        wj, ij, auxj = JMoE.route(jl["moe"], cfg_j, jx)
        w, i, aux = MoE.route(lp["moe"], cfg, tx, with_aux=True)
        assert w.shape == (3, 40, k) and i.shape == (3, 40, k)
        gates = torch.softmax(tx @ lp["moe"]["router"], -1).numpy()
        sure = _margin(gates, k) > 1e-5
        assert sure.mean() > 0.9
        np.testing.assert_array_equal(i.numpy()[sure], np.asarray(ij)[sure])
        np.testing.assert_allclose(w.numpy()[sure], np.asarray(wj)[sure],
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(aux.item(), float(auxj), atol=1e-6,
                                   rtol=0)
        assert MoE.route(lp["moe"], cfg, tx)[2] is None


def test_masked_dense_matches_reference(setup):
    """The batched layer and the sequential plain version against the
    reference's scan, and the MoE ``mlp_sublayer`` against the
    reference's, within 1e-5 of max |reference|."""
    cfg, cfg_j = setup["cfg"], setup["cfg_j"]
    rt = JM.Runtime()
    for lp, jl in zip(setup["params"]["layers"], setup["jlayers"]):
        jx, tx = _x(2, 24, cfg.d_model, seed=2)
        yj, _ = JMoE.moe_masked_dense(jl["moe"], cfg_j, jx)
        y, aux = MoE.moe_masked_dense(lp["moe"], cfg, tx)
        assert aux is None and y.shape == tx.shape
        assert _rel(y, yj) < 1e-5
        assert _rel(MoE.moe_masked_dense_ref(lp["moe"], cfg, tx), yj) < 1e-5
        _, aux = MoE.moe_apply(lp["moe"], cfg, tx, with_aux=True)
        np.testing.assert_allclose(
            aux.item(), float(JMoE.route(jl["moe"], cfg_j, jx)[2]),
            atol=1e-6, rtol=0)
        jx, tx = _x(24, cfg.d_model, seed=3)
        assert _rel(M.mlp_sublayer(lp, cfg, tx),
                    JM.mlp_sublayer(jl, cfg_j, rt, jx)[0]) < 1e-5


def test_masked_dense_weights_outputs_not_inputs(setup):
    """Zeroing a row's routed experts' down projections zeroes its
    output: the weight scales each expert's output and no unrouted
    expert contributes."""
    cfg = setup["cfg"]
    p = setup["params"]["layers"][0]["moe"]
    _, tx = _x(5, cfg.d_model, seed=4)
    _, idx, _ = MoE.route(p, cfg, tx)
    row = idx[0].tolist()
    q = dict(p, w_down=p["w_down"].clone())
    q["w_down"][row] = 0
    y, _ = MoE.moe_masked_dense(q, cfg, tx[:1])
    assert torch.equal(y, torch.zeros_like(y))


def test_bfloat16_layer_stays_near_the_sequential_sum(setup):
    """In bfloat16 the one reduction over E and the reference's
    sequential sum differ only by rounding."""
    cfg = setup["cfg"]
    p = {k: (v if k == "router" else v.to(torch.bfloat16))
         for k, v in setup["params"]["layers"][0]["moe"].items()}
    _, tx = _x(16, cfg.d_model, seed=5)
    tx = tx.to(torch.bfloat16)
    y, _ = MoE.moe_masked_dense(p, cfg, tx)
    want = MoE.moe_masked_dense_ref(p, cfg, tx)
    assert y.dtype == torch.bfloat16
    assert _rel(y.float(), want.float().numpy()) < 2e-2


@pytest.mark.parametrize("capacity_factor", [32.0, 0.05],
                         ids=["cap32", "cap0.05"])
def test_expert_parallel_matches_reference(setup, capacity_factor):
    """``moe_apply(impl="expert_parallel")`` on one rank against the
    reference's ``moe_expert_parallel`` on the 1-device host mesh
    (``tests/test_moe.py``'s setup): the output within 1e-5 of max
    |reference| and aux within 1e-6, at a capacity with no drops and at
    one that drops most assignments (the same ones: a different drop
    would move whole rows)."""
    from repro.launch.mesh import make_host_mesh
    cfg, cfg_j = setup["cfg"], setup["cfg_j"]
    jx, tx = _x(2, 8, cfg.d_model, seed=2)
    want, aux_j = JMoE.moe_expert_parallel(
        setup["jlayers"][0]["moe"], cfg_j, jx, mesh=make_host_mesh(),
        batch_axes=("data",), model_axis="model",
        capacity_factor=capacity_factor)
    y, aux = MoE.moe_apply(setup["params"]["layers"][0]["moe"], cfg, tx,
                           impl="expert_parallel", with_aux=True,
                           capacity_factor=capacity_factor)
    assert _rel(y, want) < 1e-5
    assert abs(float(aux) - float(aux_j)) < 1e-6
    dropped = np.abs(np.asarray(want)).sum(-1) < 1e-12
    assert (np.abs(y.numpy()).sum(-1) < 1e-12).tolist() == dropped.tolist()
    if capacity_factor < 1:
        assert dropped.any()
    with pytest.raises(ValueError, match="unknown"):
        MoE.moe_apply(setup["params"]["layers"][0]["moe"], cfg, tx,
                      impl="scatter")


@pytest.mark.parametrize("arch", sorted(_MODULES))
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_and_param_counts_match_reference(arch, reduced):
    """Every registered configuration states the reference's fields and
    gives its ``param_count`` and ``active_param_count``."""
    cfg = (get_reduced if reduced else get_config)(arch)
    ref = (jax_reduced if reduced else jax_config)(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
