"""The port's sharding rules (``repro_torch.distributed.sharding``)
against the reference's ``repro.distributed.sharding``, leaf by leaf,
for every registered configuration (full and reduced) on every mesh
shape the reference claims: ``{model: 1, 2, 4, 8, 16} × {data: 1, 2,
16}`` and the multi-pod shape, passed as ``{axis: size}`` mappings.
The port's parameters and decode caches are one dict per layer, so the
reference's two ``(repeats, count)`` stacking dims are dropped before
the comparison (and must be unsharded).  Pure shape arithmetic: no
process group, no allocation beyond the reduced models.

Also: the token-bucket floor, ``shard_params`` → ``gather_params`` and
``shard_tensor`` → ``gather_tensor`` round trips on every reduced
model, the rank layouts' head arithmetic, and ``launch.mesh``'s
checks."""
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import all_configs, get_config, get_reduced
from repro.core.alora import adapter_param_specs
from repro.distributed import sharding as ref
from repro.models.model import init_decode_caches, param_specs
from repro.serving.runner import next_pow2 as ref_next_pow2
from repro_torch.configs import get_config as port_config
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.core.alora import (init_adapter_weights, leaf_shapes,
                                    per_layer_adapters)
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as port_mesh
from repro_torch.models.model import init_params, period_segments
from repro_torch.serving.runner import next_pow2

ARCHS = sorted(all_configs())
MESHES = [{"data": d, "model": m} for m in (1, 2, 4, 8, 16)
          for d in (1, 2, 16)] + [{"pod": 2, "data": 16, "model": 16}]


@functools.lru_cache(maxsize=None)
def _cfgs(arch, reduced):
    if reduced:
        return get_reduced(arch), port_reduced(arch)
    return get_config(arch), port_config(arch)


def meta(shape):
    return torch.empty(tuple(shape), device="meta")


def ref_flat(tree):
    """{path: leaf} of a reference tree (spec trees: P leaves)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): v
            for p, v in flat}


def port_layers(ref_tree, cfg, seg_key="blocks"):
    """The reference's segment-stacked leaves (repeats, count, ...) as
    the port's per-layer list of meta tensors, with each port path's
    reference path."""
    repeats, segs = period_segments(cfg)
    stacked = ref_tree[seg_key] if seg_key else ref_tree
    layers, where = [], []
    for r in range(repeats):
        for si, (_, count) in enumerate(segs):
            seg = stacked[f"seg{si}"]
            for _ in range(count):
                layers.append(jax.tree.map(lambda s: meta(s.shape[2:]), seg))
                where.append(((seg_key,) if seg_key else ()) + (f"seg{si}",))
    return layers, where


@functools.lru_cache(maxsize=None)
def params_pair(arch, reduced):
    """(reference ShapeDtypeStruct tree, the port's meta tree, port path
    → reference path)."""
    rcfg, pcfg = _cfgs(arch, reduced)
    rtree = param_specs(rcfg)
    layers, where = port_layers(rtree, pcfg)
    ptree = {"embed": jax.tree.map(lambda s: meta(s.shape), rtree["embed"]),
             "final_norm": meta(rtree["final_norm"].shape),
             "layers": layers}
    if pcfg.is_encoder_decoder:
        enc = rtree["encoder"]
        ptree["encoder"] = {
            "layers": [jax.tree.map(lambda s: meta(s.shape[2:]),
                                    enc["blocks"])
                       for _ in range(pcfg.num_encoder_layers)],
            "final_norm": meta(enc["final_norm"].shape)}
    mapping = {}
    for path, _ in shd._paths(ptree):
        path = tuple(str(k) for k in path)
        if path[0] == "layers":
            mapping[path] = (where[int(path[1])] + path[2:], 2)
        elif path[:2] == ("encoder", "layers"):
            mapping[path] = (("encoder", "blocks") + path[3:], 2)
        else:
            mapping[path] = (path, 0)
    return rtree, ptree, mapping


def assert_leafwise(port_specs, ref_specs, mapping):
    """Each port leaf's spec equals its reference leaf's once the
    ``drop`` stacking dims (all unsharded) are cut."""
    got = {tuple(str(k) for k in p): s for p, s in shd._paths(port_specs)}
    want = ref_flat(ref_specs)
    assert set(got) == set(mapping)
    for path, (rpath, drop) in mapping.items():
        w = tuple(want[rpath])
        assert all(ax is None for ax in w[:drop]), (rpath, w)
        assert tuple(got[path]) == w[drop:], (path, got[path], w)
        assert isinstance(got[path], shd.P)


def supports(cfg, ms):
    return (cfg.num_kv_heads % ms == 0 and cfg.num_heads % ms == 0
            or cfg.head_dim % ms == 0)


# ---------------------------------------------------------------------------
# one case per (rule, configuration), every mesh shape and both sizes
# ---------------------------------------------------------------------------
def check_param_specs(arch, reduced, mesh):
    rcfg, pcfg = _cfgs(arch, reduced)
    rtree, ptree, mapping = params_pair(arch, reduced)
    assert_leafwise(shd.param_specs_tree(pcfg, ptree, mesh=mesh),
                    ref.param_specs_tree(rcfg, rtree, mesh=mesh), mapping)
    assert_leafwise(shd.param_specs_tree(pcfg, ptree),
                    ref.param_specs_tree(rcfg, rtree), mapping)


def check_fit_spec(arch, reduced, mesh):
    rcfg, pcfg = _cfgs(arch, reduced)
    _, ptree, _ = params_pair(arch, reduced)
    # every distinct (spec, shape) of the tree's leaves
    pairs = {(spec, tuple(leaf.shape)) for (_, leaf), (_, spec) in zip(
        shd._paths(ptree), shd._paths(shd.param_specs_tree(pcfg, ptree)))}
    for spec, shape in pairs:
        got = shd.fit_spec(spec, shape, mesh)
        want = ref.fit_spec(jax.sharding.PartitionSpec(*spec), shape, mesh)
        assert tuple(got) == tuple(want)


def check_fsdp(arch, reduced, mesh):
    rcfg, pcfg = _cfgs(arch, reduced)
    rtree, ptree, mapping = params_pair(arch, reduced)
    assert_leafwise(
        shd.fsdp_param_specs_tree(pcfg, ptree, mesh),
        ref.fsdp_param_specs_tree(rcfg, rtree, SimpleNamespace(shape=mesh)),
        mapping)


def check_zero1(arch, reduced, mesh):
    """The reference's ZeRO-1 rule applied to the same per-layer leaves
    (its own stacking dims dropped from shapes and specs first)."""
    if "data" not in mesh:
        return
    rcfg, pcfg = _cfgs(arch, reduced)
    rtree, ptree, mapping = params_pair(arch, reduced)
    pspecs = shd.param_specs_tree(pcfg, ptree, mesh=mesh)
    got = shd.zero1_specs(pspecs, ptree, mesh)
    rspecs = ref_flat(ref.param_specs_tree(rcfg, rtree, mesh=mesh))
    rshapes = ref_flat(rtree)
    flat_specs, flat_shapes = {}, {}
    for path, (rpath, drop) in mapping.items():
        key = "/".join(path)
        flat_specs[key] = jax.sharding.PartitionSpec(
            *tuple(rspecs[rpath])[drop:])
        flat_shapes[key] = jax.ShapeDtypeStruct(rshapes[rpath].shape[drop:],
                                                np.float32)
    want = ref.zero1_specs(flat_specs, flat_shapes,
                           SimpleNamespace(shape=mesh))
    for path, s in shd._paths(got):
        assert tuple(s) == tuple(want["/".join(map(str, path))]), path


@functools.lru_cache(maxsize=None)
def adapters_pair(arch, reduced, rank, n):
    rtree = adapter_param_specs(_cfgs(arch, reduced)[0], rank, n)
    return rtree, jax.tree.map(lambda s: meta(s.shape), rtree)


def check_adapter_specs(arch, reduced, mesh):
    rcfg, pcfg = _cfgs(arch, reduced)
    for rank, n in ((32, 3),):
        rtree, ptree = adapters_pair(arch, reduced, rank, n)
        got = shd.adapter_specs_tree(pcfg, ptree, mesh=mesh)
        want = ref_flat(ref.adapter_specs_tree(rcfg, rtree, mesh=mesh))
        for path, s in shd._paths(got):
            assert tuple(s) == tuple(want[tuple(map(str, path))]), path


def check_adapter_slot_specs(arch, reduced, mesh):
    rcfg, pcfg = _cfgs(arch, reduced)
    for kind in set(pcfg.pattern()):
        shapes = {k: (3,) + s for k, s in leaf_shapes(pcfg, 16, kind).items()}
        got = shd.adapter_slot_specs(pcfg, {k: meta(s)
                                            for k, s in shapes.items()},
                                     mesh=mesh)
        want = ref.adapter_slot_specs(
            rcfg, {k: jax.ShapeDtypeStruct(s, np.float32)
                   for k, s in shapes.items()}, mesh=mesh)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}


def check_kv_cache_spec(arch, reduced, mesh):
    rcfg, pcfg = _cfgs(arch, reduced)
    for axes in (("data",), ("pod", "data")):
        for shardable in (True, False):
            for m in (mesh, None):
                got = shd.kv_cache_spec(pcfg, axes, "model", shardable,
                                        mesh=m)
                want = tuple(ref.kv_cache_spec(rcfg, axes, "model",
                                               shardable, mesh=m))
                assert want[:2] == (None, None)
                assert tuple(got) == want[2:]


@functools.lru_cache(maxsize=None)
def caches_pair(arch, reduced):
    rcfg, pcfg = _cfgs(arch, reduced)
    rtree = jax.eval_shape(lambda: init_decode_caches(rcfg, 2, 64))
    layers, where = port_layers(rtree, pcfg, seg_key=None)
    mapping = {}
    for path, _ in shd._paths(layers):
        path = tuple(str(k) for k in path)
        mapping[path] = (where[int(path[0])] + path[1:], 2)
    return rtree, layers, mapping


def check_cache_specs(arch, reduced, mesh):
    rcfg, pcfg = _cfgs(arch, reduced)
    rtree, ptree, mapping = caches_pair(arch, reduced)
    for axes, shardable in ((("data",), True), (("data",), False)):
        if not supports(pcfg, mesh["model"]):
            with pytest.raises(ValueError):
                shd.cache_specs_tree(pcfg, ptree, mesh, axes,
                                     batch_shardable=shardable)
            with pytest.raises(AssertionError):
                ref.cache_specs_tree(rcfg, rtree, mesh, axes,
                                     batch_shardable=shardable)
            continue
        assert_leafwise(
            shd.cache_specs_tree(pcfg, ptree, mesh, axes,
                                 batch_shardable=shardable),
            ref.cache_specs_tree(rcfg, rtree, mesh, axes,
                                 batch_shardable=shardable), mapping)


def check_mixed_step(arch, reduced, mesh):
    rcfg, pcfg = _cfgs(arch, reduced)
    for data_axis in (None, "data"):
        got = shd.mixed_step_shardings(pcfg, mesh, data_axis=data_axis)
        want = ref.mixed_step_shardings(rcfg, mesh, data_axis=data_axis)
        for f in ("kv_pool", "ssm_pool", "conv_pool", "attn_out", "tok_buf",
                  "tok_meta", "tok_embeds", "replicated"):
            g, w = getattr(got, f), getattr(want, f)
            assert (g is None) == (w is None), f
            if g is not None:
                assert tuple(g) == tuple(w), (f, g, w)


def check_batch_specs(arch, reduced, mesh):
    for axes in (("data",), ("pod", "data")):
        got, want = shd.batch_specs(axes), ref.batch_specs(axes)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}


RULES = {"param_specs_tree": check_param_specs, "fit_spec": check_fit_spec,
         "fsdp_param_specs_tree": check_fsdp, "zero1_specs": check_zero1,
         "adapter_specs_tree": check_adapter_specs,
         "adapter_slot_specs": check_adapter_slot_specs,
         "kv_cache_spec": check_kv_cache_spec,
         "cache_specs_tree": check_cache_specs,
         "mixed_step_shardings": check_mixed_step,
         "batch_specs": check_batch_specs}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("rule", sorted(RULES))
def test_rule_matches_reference(rule, arch):
    for reduced in (False, True):
        for mesh in MESHES:
            RULES[rule](arch, reduced, mesh)


# ---------------------------------------------------------------------------
# the token axis, the slices, the meshes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lo", [1, 2, 4, 8, 16])
def test_token_bucket_floor(lo):
    """pow2 token buckets double from the data-axis size: every bucket
    divides it, is tight, and equals the reference's."""
    for n in range(1, 4097):
        b = next_pow2(n, lo=lo)
        assert b == ref_next_pow2(n, lo=lo)
        assert b >= n and b % lo == 0 and b & (b - 1) == 0
        assert b < 2 * max(n, lo)


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_round_trips(arch):
    """On every reduced model and model axis 1/2/4/8: ``shard_params``
    (and ``shard_adapter_layers`` on an adapter's per-layer weights)
    then ``gather_params`` gives every leaf back exactly; each rank's
    attention layout is whole heads with an integral query group and
    K/V heads that are the ones its queries read; a rank's slice is
    kept as it is when sharded again; and ``shard_tensor`` →
    ``gather_tensor`` under the reference's spec round-trips every leaf
    on every mesh."""
    cfg = port_reduced(arch)
    params = init_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    adapter = per_layer_adapters(cfg, init_adapter_weights(
        torch.Generator().manual_seed(1), cfg, 8, device="cpu"))
    leaves = [t for _, t in shd._paths(params)]
    for ms in (1, 2, 4, 8):
        mesh = {"data": 1, "model": ms}
        ad = [shd.shard_adapter_layers(adapter, cfg, mesh, {"model": mr})
              for mr in range(ms)]
        for a, b in zip(shd._paths(adapter),
                        shd._paths(shd.gather_params(ad, cfg, ms))):
            assert torch.equal(a[1], b[1])
        shards = []
        for mr in range(ms):
            lay = shd.rank_layout(cfg, ms, mr)
            coords = {"data": 0, "model": mr}
            s = shd.shard_params(params, cfg, mesh, coords)
            again = shd.shard_params(s, cfg, mesh, coords)
            for (_, a), (_, b) in zip(shd._paths(s), shd._paths(again)):
                assert a is b
            G = len(lay.q_heads) // len(lay.kv_heads)
            assert G * len(lay.kv_heads) == len(lay.q_heads)
            assert [h // (cfg.num_heads // cfg.num_kv_heads)
                    for h in lay.q_heads] == \
                [lay.kv_heads[i // G] for i in range(len(lay.q_heads))]
            assert lay.attn == (ms > 1 and len(lay.q_heads) < cfg.num_heads)
            shards.append(s)
        back = [t for _, t in shd._paths(shd.gather_params(shards, cfg, ms))]
        assert len(back) == len(leaves)
        for a, b in zip(leaves, back):
            assert a.shape == b.shape and torch.equal(a, b)
    for mesh in ({"data": 2, "model": 2}, {"data": 1, "model": 4},
                 {"pod": 2, "data": 1, "model": 2}):
        specs = shd.param_specs_tree(cfg, params, mesh=mesh)
        for (_, t), (_, spec) in zip(shd._paths(params), shd._paths(specs)):
            parts = [shd.shard_tensor(t, spec, mesh, c)
                     for c in shd.all_coords(mesh)]
            assert torch.equal(shd.gather_tensor(parts, spec, mesh), t)


def test_host_mesh_checks_world_size():
    """Without a process group of ``data × model`` ranks the mesh raises
    and names the count it needs; the production meshes likewise."""
    with pytest.raises(RuntimeError, match="needs 1000000 ranks"):
        port_mesh.make_host_mesh(data=1000, model=1000)
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        port_mesh.make_host_mesh(data=1, model=2)
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        port_mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        port_mesh.make_production_mesh(multi_pod=True)
    assert port_mesh.batch_axes_of({"data": 2, "model": 2}) == ("data",)
    assert port_mesh.batch_axes_of(
        {"pod": 2, "data": 2, "model": 2}) == ("pod", "data")
