"""The port's step builder and dry run (``repro_torch.launch.steps``,
``launch.dryrun``, ``launch.hlo_analysis``) against the reference's
shapes and against the port's own sharded runs.

* ``steps.input_specs`` and ``adapter_specs`` equal the reference's
  ``jax.eval_shape`` of its own for every assigned architecture × input
  shape (the port's per-layer caches against the reference's
  segment-stacked ones), and ``build_step``'s parameter tree the
  reference's ``param_specs`` layer by layer;
* the dry run's per-rank bytes at (data, model) = (2, 2) equal the sum of
  ``shard_params``' real tensors (and of the ZeRO-1 moments of a real
  ``init_sharded_train_state``) on every rank;
* ``hlo_analysis.step_collectives`` equals, kind by kind in counts and
  result bytes, ``distributed.parallel.COLLECTIVES`` counted on four
  gloo ranks running each step (prefill, decode, train with remat) on
  reduced models: dense, SSM, MoE (masked dense and expert-parallel),
  whisper, phi-3-vision and context-parallel at (2, 2), and a dense, an
  SSM, an expert-parallel and a context-parallel step again at (1, 4);
* the CLIs: ``dryrun --arch/--shape/--mesh/--out/--set/--tag`` and
  ``train --dryrun``, the report and the roofline section rendering the
  records (the temp column "-"), every production record fitting.
"""
import functools
import json
import math
import threading

import jax
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch import steps as JS
from repro.models import model as JM
from repro_torch.benchmarks import report, roofline
from repro_torch.benchmarks import sharded_model as SM
from repro_torch.common import tree_leaves, tree_paths
from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, InputShape,
                                 get_config, get_reduced)
from repro_torch.distributed.sharding import (rank_layout, shard_params,
                                              tree_bytes, zero1_local_dims)
from repro_torch.distributed.spawn import launch
from repro_torch.launch import dryrun, steps
from repro_torch.launch import train as train_cli
from repro_torch.launch.hlo_analysis import (collective_stats,
                                             step_collectives)
from repro_torch.models import model as M
from repro_torch.training.optimizer import init_sharded_adamw

torch.set_num_threads(1)

MESH = {"data": 2, "model": 2}
# (name, arch, mode, Runtime keywords) of the collective cross-check at
# (data, model) = (2, 2)
STEPS = [("granite/prefill", "granite-3.2-8b", "prefill", {}),
         ("granite/decode", "granite-3.2-8b", "decode", {}),
         ("granite/train", "granite-3.2-8b", "train", {"remat": True}),
         ("mamba2/prefill", "mamba2-2.7b", "prefill", {}),
         ("mamba2/train", "mamba2-2.7b", "train", {"remat": True}),
         ("moe-ep/prefill", "granite-moe-1b-a400m", "prefill",
          {"moe_impl": "expert_parallel"}),
         ("moe-ep/train", "granite-moe-1b-a400m", "train",
          {"moe_impl": "expert_parallel", "remat": True}),
         ("moe/train", "granite-moe-1b-a400m", "train", {}),
         ("whisper/train", "whisper-large-v3", "train", {"remat": True}),
         ("vision/train", "phi-3-vision-4.2b", "train", {}),
         ("whisper/decode", "whisper-large-v3", "decode", {}),
         ("mamba2/decode", "mamba2-2.7b", "decode", {}),
         ("moe-ep/decode", "granite-moe-1b-a400m", "decode",
          {"moe_impl": "expert_parallel"}),
         ("vision/prefill", "phi-3-vision-4.2b", "prefill", {}),
         ("cp/prefill", "stablelm-12b", "prefill",
          {"context_parallel": True})]
# ... and these again at (1, 4): no data axis, and granite's two K/V
# heads each on two model ranks
AT_1X4 = ("granite/prefill", "granite/decode", "granite/train",
          "mamba2/train", "moe-ep/prefill", "moe-ep/train", "cp/prefill")
CROSS = [(name, arch, mode, kw, (2, 2)) for name, arch, mode, kw in STEPS] \
    + [(name + "@1x4", arch, mode, kw, (1, 4))
       for name, arch, mode, kw in STEPS if name in AT_1X4]
B, S = 4, 16


@functools.lru_cache(maxsize=None)
def reduced(arch):
    cfg = get_reduced(arch)
    return cfg, M.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")


@pytest.fixture(scope="module")
def counted():
    """Each step's collectives on four gloo ranks at (2, 2) or (1, 4),
    run in the background while the shape tests run."""
    cases = [(name, "step", (reduced(a)[0], reduced(a)[1], mode, B, S),
              dict(rt_kw=kw, **({} if mesh == (2, 2) else {"mesh": mesh})))
             for name, a, mode, kw, mesh in CROSS]
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
        return [r[name]["step"] for r in out["res"]]
    yield get
    th.join(timeout=600)


class _AxisNames:
    """What the reference's ``make_runtime`` reads of a mesh."""
    axis_names = ("data", "model")


def _sds(t):
    return (tuple(t.shape), str(t.dtype).replace("torch.", ""))


def _jsds(s):
    return (tuple(s.shape), str(s.dtype))


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_input_and_adapter_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    repeats, segs = M.period_segments(cfg)
    for shape in INPUT_SHAPES.values():
        rt = steps.make_runtime(cfg, MESH, shape)
        jrt = JS.make_runtime(jcfg, _AxisNames(), shape)
        assert (rt.moe_impl, rt.remat, rt.window_override) == \
            (jrt.moe_impl, jrt.remat, jrt.window_override)
        got = steps.input_specs(cfg, shape, rt)
        want = JS.input_specs(jcfg, shape, jrt)
        assert set(got) == set(want)
        for key in got:
            if key == "caches":
                layers = got[key]
                # the reference's caches stack each segment's layers
                li = 0
                for r in range(repeats):
                    for si, (_, count) in enumerate(segs):
                        for c in range(count):
                            seg = want[key][f"seg{si}"]
                            assert {k: _sds(v) for k, v in
                                    layers[li].items()} == \
                                {k: (s.shape[2:], str(s.dtype))
                                 for k, s in seg.items()}
                            li += 1
            elif isinstance(got[key], dict):
                assert {k: _sds(v) for k, v in got[key].items()} == \
                    {k: _jsds(v) for k, v in want[key].items()}
            else:
                assert _sds(got[key]) == _jsds(want[key])
    ad, jad = steps.adapter_specs(cfg), JS.adapter_specs(jcfg)
    assert {s: {k: _sds(v) for k, v in leaves.items()}
            for s, leaves in ad.items()} == \
        {s: {k: _jsds(v) for k, v in leaves.items()}
         for s, leaves in jad.items()}


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_specs_match_reference_layer_by_layer(arch):
    cfg = get_config(arch)
    got = M.param_specs(cfg)
    want = JM.param_specs(jax_config(arch))
    repeats, segs = M.period_segments(cfg)
    li = 0
    for r in range(repeats):
        for si, (_, count) in enumerate(segs):
            for c in range(count):
                seg = want["blocks"][f"seg{si}"]
                flat = {k: v for k, v in jax.tree_util.tree_flatten_with_path(
                    seg)[0]}
                mine = {tuple(str(x) for x in p): t for p, t in
                        tree_paths(got["layers"][li])}
                assert len(mine) == len(flat)
                li += 1
    n_got = sum(math.prod(t.shape) for t in tree_leaves(got))
    n_want = sum(math.prod(s.shape) for s in jax.tree.leaves(want))
    assert n_got == n_want
    assert {k: _sds(v) for k, v in got["embed"].items()} == \
        {k: _jsds(v) for k, v in want["embed"].items()}


@pytest.mark.parametrize("arch", ["granite-3.2-8b", "mamba2-2.7b",
                                  "granite-moe-1b-a400m",
                                  "whisper-large-v3"])
def test_dryrun_bytes_equal_the_ranks_real_tensors(arch):
    """The dry run's per-rank params, adapters and ZeRO-1 moments at
    (2, 2) on the reduced model equal the bytes of ``shard_params``' real
    slices and of a real ``init_sharded_adamw``, on every rank."""
    cfg, params = reduced(arch)
    from repro_torch.core.alora import (PAPER_ALORA_RANK,
                                        init_adapter_weights,
                                        stack_adapters)
    from repro_torch.distributed.sharding import shard_adapter_layers
    ad = stack_adapters(cfg, [init_adapter_weights(
        torch.Generator().manual_seed(1), cfg, PAPER_ALORA_RANK,
        device="cpu")], PAPER_ALORA_RANK)
    for mode in ("prefill", "train"):
        shape = InputShape("t", S, B, mode)
        spec = steps.build_step(cfg, shape, MESH)
        mem = dryrun.memory_record(spec)
        for dr in range(2):
            for mr in range(2):
                coords = {"data": dr, "model": mr}
                local = shard_params(params, cfg, MESH, coords)
                assert mem["params_bytes"] == tree_bytes(local)
                if mode == "prefill":
                    assert mem["adapters_bytes"] == tree_bytes(
                        shard_adapter_layers(ad, cfg, MESH, coords))
                    continue
                dims = zero1_local_dims(cfg, M.param_specs(cfg), MESH,
                                        rank_layout(cfg, 2, mr))
                opt = init_sharded_adamw(local, dims, 2, dr)
                assert mem["opt_state_bytes"] == tree_bytes(
                    [opt.mu, opt.nu, opt.step])
        assert mem["temp_size_in_bytes"] is None


@pytest.mark.parametrize("name,arch,mode,kw,mesh", CROSS,
                         ids=[s[0] for s in CROSS])
def test_collective_list_matches_the_counter(counted, name, arch, mode, kw,
                                             mesh):
    cfg = reduced(arch)[0]
    mesh = dict(zip(("data", "model"), mesh))
    rt = M.Runtime(mesh=mesh, batch_axes=("data",), **kw)
    want = collective_stats(step_collectives(cfg, mode, B, S, mesh, rt))
    for got in counted(name):
        assert {k: v["count"] for k, v in got.items()} == want.counts
        assert {k: v["bytes"] for k, v in got.items()} == \
            {k: int(v) for k, v in want.by_kind.items()}


def test_dryrun_cli_and_report(tmp_path, capsys, monkeypatch):
    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--arch", "granite-moe-1b-a400m", "--shape",
                        "train_4k", "--mesh", "both", "--out", str(out),
                        "--set", "capacity_factor=2.0", "--tag", "cf2"]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    for r in recs:
        assert r["ok"] and r["tag"] == "cf2"
        assert r["overrides"] == {"capacity_factor": 2.0}
        assert r["memory"]["temp_size_in_bytes"] is None
        assert r["fits_without_activations"]
        assert r["roofline"]["dominant"] in ("compute", "memory",
                                             "collective")
    rec = train_cli.main(["--dryrun", "--arch", "stablelm-12b"])
    assert rec["ok"] and rec["shape"] == "train_4k" \
        and rec["mesh"] == "16x16"
    assert rec["runtime"]["remat"]
    monkeypatch.setattr(report, "BASE", str(tmp_path))
    (tmp_path / "dryrun_all.jsonl").write_text(
        "\n".join(json.dumps(r) for r in recs[:1]) + "\n")
    (tmp_path / "dryrun_multipod.jsonl").write_text(
        json.dumps(recs[1]) + "\n")
    capsys.readouterr()
    report.main()
    text = capsys.readouterr().out
    assert "| granite-moe-1b-a400m | train_4k |" in text
    assert "Compiled-step invariant audit" not in text
    row = next(line for line in text.splitlines()
               if line.startswith("| granite-moe-1b-a400m | train_4k | "))
    assert row.rstrip().endswith("| - |")
    roofline.run(str(tmp_path / "dryrun_all.jsonl"))
    assert "roofline/granite-moe-1b-a400m/train_4k/16x16" in \
        capsys.readouterr().out


def test_production_meshes_fit_one_card_without_activations():
    """Every assigned (arch × shape) on both production meshes: the
    rank's arguments and outputs fit one H100's 80 GB (activations not
    counted), and granite-3.2-8b at model = 2 holds half its weights
    and one head-aligned half of its padded vocab."""
    for arch in ASSIGNED_ARCHS:
        for shape in INPUT_SHAPES:
            for mesh in dryrun.MESHES:
                r = dryrun.run_one(arch, shape, mesh, verbose=False)
                assert r["ok"], r.get("error")
                assert r["fits_without_activations"], (arch, shape, mesh)
    g = dryrun.run_one("granite-3.2-8b", "prefill_32k", "model2",
                       verbose=False, mesh={"data": 1, "model": 2})
    cfg = get_config("granite-3.2-8b")
    lay = rank_layout(cfg, 2, 0)
    assert g["memory"]["params_bytes"] == sum(
        math.prod(lay.local_shape(p, tuple(t.shape))) * 2
        for p, t in tree_paths(M.param_specs(cfg)))
