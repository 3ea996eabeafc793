"""The port's layers and model assembly against ``repro.models`` on the
reduced granite with converted weights (float32).  Tolerance 1e-5: the
two frameworks' matmuls and reductions sum in different orders.  The
layouts, init shapes and MLP are also held on the reduced dense families
with the non-gated activations (minitron's squared ReLU, starcoder2's
tanh GELU; no ``w_gate``, untied ``unembed``), the MLP within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core.alora import init_adapter_weights as jax_adapter
from repro.core.alora import per_layer_adapters as jax_per_layer
from repro.core.alora import stack_adapters as jax_stack
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_reduced
from repro_torch.core.alora import per_layer_adapters, stack_adapters
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.convert import adapters_from_jax, params_from_jax

# one intra-op thread: this file shares the CPU with the rest of the suite
torch.set_num_threads(1)

RTOL = ATOL = 1e-5


def _setup(arch):
    cfg_j = jax_reduced(arch)
    cfg = get_reduced(arch)
    pj = JM.init_params(jax.random.key(0), cfg_j)
    ads = [jax_adapter(jax.random.key(k), cfg_j, 8) for k in (5, 6)]
    jstack = jax_stack(cfg_j, ads, 8)
    params = params_from_jax(jax.tree.map(np.asarray, pj), cfg, "cpu")
    stack = stack_adapters(cfg, [adapters_from_jax(
        jax.tree.map(np.asarray, a), cfg, "cpu") for a in ads], 8)
    jlayers = [lp for _, lp in JM.iter_layers(pj, cfg_j)]
    return dict(cfg_j=cfg_j, cfg=cfg, pj=pj, params=params, jlayers=jlayers,
                jal=jax_per_layer(cfg_j, jstack),
                al=per_layer_adapters(cfg, stack))


@pytest.fixture(scope="module")
def setup():
    return _setup("granite-3.2-8b")


# the reduced dense families of each non-gated activation
@pytest.fixture(scope="module", params=["minitron-4b", "starcoder2-3b"],
                ids=["squared_relu", "gelu"])
def family(request):
    return _setup(request.param)


def _x(*shape, seed=0):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(got, want, tol=RTOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def _check_layouts(s):
    cfg, params, pj = s["cfg"], s["params"], s["pj"]
    assert params["embed"]["tok"].shape == (L.padded_vocab(cfg),
                                            cfg.d_model)
    assert L.padded_vocab(cfg) == JL.padded_vocab(s["cfg_j"])
    assert set(params["embed"]) == set(pj["embed"])
    for k in pj["embed"]:
        np.testing.assert_array_equal(params["embed"][k].numpy(),
                                      np.asarray(pj["embed"][k]))
    np.testing.assert_array_equal(params["final_norm"].numpy(),
                                  np.asarray(pj["final_norm"]))
    for (kind, lp), jl in zip(M.iter_layers(params, cfg), s["jlayers"]):
        assert kind == "attn"
        for k in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(lp["attn"][k].numpy(),
                                          np.asarray(jl["attn"][k]))
        assert set(lp["mlp"]) == set(jl["mlp"])
        for k in jl["mlp"]:
            np.testing.assert_array_equal(lp["mlp"][k].numpy(),
                                          np.asarray(jl["mlp"][k]))


def _check_init_shapes(s):
    cfg = s["cfg"]
    mine = M.init_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    ref = s["params"]
    assert {k: v.shape for k, v in mine["embed"].items()} == \
        {k: v.shape for k, v in ref["embed"].items()}
    for a, b in zip(mine["layers"], ref["layers"]):
        for sub in ("attn", "mlp"):
            assert {k: v.shape for k, v in a[sub].items()} == \
                {k: v.shape for k, v in b[sub].items()}
    assert M.period_segments(cfg) == JM.period_segments(s["cfg_j"])


def test_converted_params_keep_layouts(setup):
    _check_layouts(setup)


def test_init_params_shapes_match_reference(setup):
    _check_init_shapes(setup)


def test_dense_family_converted_params_keep_layouts(family):
    assert "w_gate" not in family["params"]["layers"][0]["mlp"]
    assert "unembed" in family["params"]["embed"]
    _check_layouts(family)


def test_dense_family_init_params_shapes_match_reference(family):
    _check_init_shapes(family)


def test_dense_family_mlp_matches_reference(family):
    """``mlp_apply`` and the MLP sublayer with the non-gated activation,
    float32, within 1e-6."""
    cfg, cfg_j = family["cfg"], family["cfg_j"]
    for lp, jl in zip(family["params"]["layers"], family["jlayers"]):
        jx, tx = _x(6, cfg.d_model, seed=3)
        _close(L.mlp_apply(lp["mlp"], cfg, tx),
               JL.mlp_apply(jl["mlp"], cfg_j, jx), 1e-6)
        _close(M.mlp_sublayer(lp, cfg, tx),
               JM.mlp_sublayer(jl, cfg_j, JM.Runtime(), jx)[0], 1e-6)
    jx, tx = _x(40, seed=8)
    for name in ("squared_relu", "gelu"):
        _close(L.activation_fn(name)(tx), JL.activation_fn(name)(jx), 1e-6)


def test_rmsnorm_and_rope(setup):
    cfg = setup["cfg"]
    jx, tx = _x(9, cfg.d_model)
    jw, tw = _x(cfg.d_model, seed=1)
    _close(L.rmsnorm(tx, tw, cfg.norm_eps), JL.rmsnorm(jx, jw, cfg.norm_eps))
    jq, tq = _x(9, cfg.num_heads, cfg.head_dim, seed=2)
    pos = np.array([0, 1, 5, 17, 300, 301, 302, 1000, 2047], np.int32)
    _close(L.apply_rope(tq, torch.from_numpy(pos), cfg.rope_theta),
           JL.apply_rope(jq, jnp.asarray(pos), cfg.rope_theta))


def test_mlp_and_out_project(setup):
    cfg, lp, jl = setup["cfg"], setup["params"]["layers"][1], \
        setup["jlayers"][1]
    jx, tx = _x(6, cfg.d_model, seed=3)
    _close(L.mlp_apply(lp["mlp"], cfg, tx), JL.mlp_apply(jl["mlp"], cfg, jx))
    _close(M.mlp_sublayer(lp, cfg, tx),
           JM.mlp_sublayer(jl, setup["cfg_j"], JM.Runtime(), jx)[0])
    jo, to = _x(6, cfg.num_heads, cfg.head_dim, seed=4)
    _close(L.out_project(lp["attn"], cfg, to),
           JL.out_project(jl["attn"], cfg, jo))


@pytest.mark.parametrize("grouped", [False, True], ids=["dense", "grouped"])
@pytest.mark.parametrize("layer", [0, 1])
def test_qkv_project_with_adapter_stack(setup, grouped, layer):
    cfg = setup["cfg"]
    jx, tx = _x(12, cfg.d_model, seed=5 + layer)
    idx = np.array([0, 1, 2, 2, 0, 1, 1, 0, 2, 0, 0, 1], np.int32)
    act = np.array([1, 2], np.int32)
    got = L.qkv_project(setup["params"]["layers"][layer]["attn"], cfg, tx,
                        setup["al"][layer], torch.from_numpy(idx),
                        active_slots=torch.from_numpy(act) if grouped
                        else None)
    want = JL.qkv_project(setup["jlayers"][layer]["attn"], cfg, jx,
                          setup["jal"][layer], jnp.asarray(idx),
                          lora_impl="ref" if grouped else "dense",
                          active_slots=jnp.asarray(act))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


def test_logits_for_and_embed(setup):
    cfg = setup["cfg"]
    jh, th = _x(5, cfg.d_model, seed=7)
    _close(M.logits_for(setup["params"], cfg, th),
           JM.logits_for(setup["pj"], setup["cfg_j"], jh))
    toks = np.array([3, 0, 511, 77], np.int32)
    _close(L.embed(setup["params"]["embed"], torch.from_numpy(toks)),
           JL.embed(setup["pj"]["embed"], jnp.asarray(toks)))
