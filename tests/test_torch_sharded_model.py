"""The port's sharded full-sequence model (``Runtime.mesh``) on CPU ranks
against the reference's unsharded model.

Ranks are processes of one gloo group (``distributed.spawn.launch``);
each runs ``repro_torch.benchmarks.sharded_model``'s cases (no JAX) on
reduced float32 models with the port's weights from a seed, cutting its
own slice of them.  The oracle is ``repro.models`` in this process on the
same weights (``convert.params_to_jax``):

* ``forward_full`` hidden states and the greedy ``decode_step`` logits
  of granite (adapted), mamba2 (adapted), zamba2, whisper and
  phi-3-vision at (data, model) = (1, 2), (2, 2) and (1, 4) within 1e-5
  of max |reference|, the 8 greedy tokens exact;
* ``window_override`` (granite at (1, 2)) against the reference's
  ``Runtime(window_override=...)`` decode ring buffer;
* ``moe_expert_parallel`` at model = 2 against the reference's on the
  1-device host mesh (``tests/test_moe.py``'s setup) at capacity factors
  32 and 0.05: the same drops, outputs within 1e-5; at data = 2 each data
  shard against the reference on that shard's rows, aux their mean;
* the context-parallel forward and the gradients of ``sum(hidden · R)``
  at (1, 2) and (2, 2) against the reference's
  ``Runtime(context_parallel=True)`` on one device
  (``tests/test_perf_variants.py``).

Two worlds run every case, started once in the background while the
reference computes: two ranks for (1, 2), four for (2, 2) and (1, 4)."""
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
from repro.models import moe as JMoE
from repro_torch.benchmarks import sharded_model as SM
from repro_torch.common import tree_at, tree_paths
from repro_torch.configs import get_reduced
from repro_torch.core.alora import init_adapter_weights, stack_adapters
from repro_torch.distributed.spawn import launch
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.model import init_params

torch.set_num_threads(1)

TOL = 1e-5
B, S, DECODE = 2, 16, 8
ARCHS = ["granite-3.2-8b", "mamba2-2.7b", "zamba2-2.7b", "whisper-large-v3",
         "phi-3-vision-4.2b"]
ADAPTED = ("granite-3.2-8b", "mamba2-2.7b")
WINDOW = 8
CAPS = (32.0, 0.05)
MOE = "granite-moe-1b-a400m"
CP = "stablelm-12b"
jax_forward = jax.jit(JM.forward_full, static_argnums=(1, 3),
                      static_argnames=("return_caches",))
jax_decode = jax.jit(JM.decode_step, static_argnums=(1, 5))


def rel(got, want) -> float:
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def zoo(arch):
    """(port cfg, params, stacked adapters | None, inputs)."""
    cfg = get_reduced(arch)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.RandomState(1)
    inputs = {"tokens": rng.randint(0, cfg.vocab_size, (B, S))}
    n = {"audio": cfg.encoder_seq_len, "vision": cfg.num_patches}.get(
        cfg.frontend)
    if n is not None:
        inputs["extra_embeds"] = (rng.randn(B, n, cfg.d_model) * 0.05) \
            .astype(np.float32)
    ad = None
    if arch in ADAPTED:
        w = init_adapter_weights(torch.Generator().manual_seed(5), cfg, 8,
                                 device="cpu")
        # B amplified so that adapted positions move the outputs
        w = {s: {k: v * 30.0 if k.startswith("b") else v
                 for k, v in l.items()} for s, l in w.items()}
        ad = stack_adapters(cfg, [w], 8)
        inputs["adapter_idx"] = np.where(np.arange(S) >= S // 2, 1, 0)[
            None].repeat(B, 0).astype(np.int32)
    return cfg, params, ad, inputs


def model_cases(mesh_kw=None):
    kw = {} if mesh_kw is None else {"mesh": mesh_kw}
    tag = "" if mesh_kw is None else "@%dx%d" % mesh_kw
    out = []
    for a in ARCHS:
        cfg, params, ad, inputs = zoo(a)
        out.append((a + tag, "model", (cfg, params, inputs),
                    dict(adapters=ad, decode=DECODE, **kw)))
    return out


def moe_inputs():
    cfg, params, _, _ = zoo(MOE)
    x = np.random.RandomState(2).randn(4, 8, cfg.d_model).astype(np.float32)
    return cfg, params["layers"][0]["moe"], x


def cp_inputs():
    cfg, params, _, _ = zoo(CP)
    rng = np.random.RandomState(3)
    return (cfg, params, rng.randint(0, cfg.vocab_size, (4, 32)),
            rng.randn(4, 32, cfg.d_model).astype(np.float32))


def world_cases(world):
    """(data, model) and the cases of each world."""
    moe = [(f"moe{c}", "moe", moe_inputs(), dict(capacity_factor=c))
           for c in CAPS]
    cp = [("cp", "cp", cp_inputs(), {})]
    if world == "2":
        cfg, params, ad, inputs = zoo("granite-3.2-8b")
        window = [("window", "model", (cfg, params, inputs),
                   dict(adapters=ad, decode=DECODE,
                        rt_kw={"window_override": WINDOW}))]
        return (1, 2), model_cases() + window + moe + cp
    return (2, 2), model_cases() + model_cases((1, 4)) + moe + cp


WORLDS = ("2", "4")


@pytest.fixture(scope="module")
def ranks():
    """Each world's per-rank results, run in background threads (the
    ranks are processes) while the tests compute the oracle."""
    out, threads = {}, {}

    def run(name):
        (data, model), cases = world_cases(name)
        try:
            out[name] = launch(SM.run_cases, cases, data=data, model=model,
                               device="cpu", timeout=300)
        except Exception as e:          # reported by the test that reads it
            out[name] = e

    for name in WORLDS:
        threads[name] = threading.Thread(target=run, args=(name,))
        threads[name].start()

    def get(world, case):
        threads[world].join(timeout=600)
        res = out[world]
        if isinstance(res, Exception):
            raise res
        return [r[case] for r in res]
    yield get
    for t in threads.values():
        t.join(timeout=600)


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


@functools.lru_cache(maxsize=None)
def oracle(arch, window=0):
    """The reference's forward_full, last-position logits and greedy
    decode on the port's weights."""
    cfg, params, ad, inputs = zoo(arch)
    cfg_j = jax_reduced(arch)
    jp = jtree(params_to_jax(params, cfg))
    jad = None if ad is None else jtree(jax.tree.map(lambda t: t.numpy(), ad))
    rt = JM.Runtime(window_override=window)
    ex = inputs.get("extra_embeds")
    aidx = inputs.get("adapter_idx")
    h, _, c = jax_forward(
        jp, cfg_j, jnp.asarray(inputs["tokens"], jnp.int32), rt,
        extra_embeds=None if ex is None else jnp.asarray(ex), adapters=jad,
        adapter_idx=None if aidx is None else jnp.asarray(aidx),
        return_caches=True)
    n = h.shape[1]
    logits = [JM.logits_for(jp, cfg_j, h[:, -1:])]
    c = JM.prefill_to_decode_caches(cfg_j, c, n, n + DECODE, rt)
    on = None if jad is None else jnp.ones((B, 1), jnp.int32)
    tok = jnp.argmax(logits[0], -1).astype(jnp.int32)
    toks = [tok[:, 0]]
    for i in range(DECODE):
        lg, c = jax_decode(jp, cfg_j, tok, c, jnp.int32(n + i), rt,
                           adapters=jad, adapter_idx=on)
        logits.append(lg)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        toks.append(tok[:, 0])
    return (np.asarray(h), np.stack([np.asarray(x[:, 0]) for x in logits]),
            np.stack([np.asarray(t) for t in toks]))


def check_model(res, want):
    h, logits, toks = want
    for r in res:
        assert rel(r["hidden"], h) < TOL
        assert rel(r["logits"], logits) < TOL
        np.testing.assert_array_equal(r["tokens"], toks)


CASES = [(w, a + tag) for w, tags in (("2", ("",)), ("4", ("", "@1x4")))
         for tag in tags for a in ARCHS]


@pytest.mark.parametrize("world,case", CASES,
                         ids=[("1x2" if w == "2" else "2x2") + "-" + c
                              for w, c in CASES])
def test_sharded_forward_and_decode_match_reference(ranks, world, case):
    res = ranks(world, case)
    check_model(res, oracle(case.split("@")[0]))
    launches = res[0]["launches"]
    # CPU tensors: every wrapper runs its plain version and counts nothing
    assert not any(launches.values())
    assert res[0]["collectives"]["all-reduce"]["count"] > 0


def test_window_override_matches_reference(ranks):
    """granite at (1, 2) under ``window_override=8``: a ring buffer of 8
    decode slots, as the reference's; the windowed logits differ from
    the unwindowed ones."""
    res = ranks("2", "window")
    want = oracle("granite-3.2-8b", WINDOW)
    check_model(res, want)
    assert rel(want[1][-1], oracle("granite-3.2-8b")[1][-1]) > 1e-3


@functools.lru_cache(maxsize=None)
def moe_oracle(rows, cap):
    cfg, p, x = moe_inputs()
    f = jax.jit(functools.partial(
        JMoE.moe_expert_parallel, cfg=jax_reduced(MOE), mesh=jax_host_mesh(),
        batch_axes=("data",), model_axis="model", capacity_factor=cap))
    y, aux = f({k: jnp.asarray(v.numpy()) for k, v in p.items()},
               x=jnp.asarray(x[rows[0]:rows[1]]))
    return np.asarray(y), float(aux)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("cap", CAPS)
def test_expert_parallel_matches_reference(ranks, world, cap):
    """Each rank's rows (its data shard) against the reference's
    ``moe_expert_parallel`` on those rows: outputs within 1e-5, the same
    rows dropped; aux the mean of the shards' (the reference's pmean)."""
    res = ranks(world, f"moe{cap}")
    auxes = []
    for r in res:
        y, aux = moe_oracle(tuple(r["rows"]), cap)
        assert rel(r["y"], y) < TOL
        dropped = np.abs(y).sum(-1) < 1e-12
        assert ((np.abs(r["y"]).sum(-1) < 1e-12) == dropped).all()
        if cap < 1:
            assert dropped.any()
        auxes.append(float(aux))
    want_aux = float(np.mean(auxes[::2] if world == "4" else auxes))
    for r in res:
        assert abs(r["aux"] - want_aux) < 1e-6


@functools.lru_cache(maxsize=None)
def cp_oracle():
    cfg, params, toks, w = cp_inputs()
    cfg_j = jax_reduced(CP)
    jp = jtree(params_to_jax(params, cfg))
    rt = JM.Runtime(mesh=jax_host_mesh(), batch_axes=("data",),
                    shard_activations=True, context_parallel=True)

    def loss(p):
        h, _, _ = JM.forward_full(p, cfg_j, jnp.asarray(toks, jnp.int32), rt)
        return jnp.sum(h.astype(jnp.float32) * w), h
    (_, h), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(jp)
    return np.asarray(h), params_from_jax(jax.tree.map(np.asarray, g), cfg,
                                          "cpu")


@pytest.mark.parametrize("world", WORLDS)
def test_context_parallel_forward_and_grads_match_reference(ranks, world):
    """Hidden states within 1e-5 of max |reference|; each weight's
    gradient (the rank's FSDP shards, gathered) within 1e-5 of its own
    max; K/V and the per-layer weights all-gathered."""
    h, grads = cp_oracle()
    for r in ranks(world, "cp"):
        assert rel(r["hidden"], h) < TOL
        for path, g in tree_paths(r["grads"]):
            want = tree_at(grads, path)
            if float(want.abs().max()) > 0:
                assert rel(g, want.numpy()) < TOL, path
            else:
                assert not np.abs(g).any(), path
        assert r["collectives"]["all-gather"]["count"] > 0


def test_ssm_delta_pads_a_rank_width_for_the_kernel(monkeypatch):
    """A rank's slice of the reduced mamba2's input projection at model =
    2 is 292 columns (its 4 heads' z and x, B and C, its 4 dt columns):
    no width the grouped-delta kernel takes.  ``lora_delta_dispatch``
    hands the kernel's wrapper B padded with zero columns to whole
    ``ALIGN``s and returns the slice's delta, the dense ``lora_delta``'s
    within 1e-6 of max."""
    from repro_torch.distributed.sharding import shard_adapter_layers
    from repro_torch.kernels.ragged_lora import (ALIGN,
                                                 ragged_grouped_lora_ref)
    from repro_torch.models import layers as L
    cfg, _, ad, inputs = zoo("mamba2-2.7b")
    local = shard_adapter_layers(ad, cfg, {"data": 1, "model": 2},
                                 {"data": 0, "model": 1})["seg0"]
    a, b = local["a"][:, 0, 0], local["b"][:, 0, 0]
    assert b.shape[-1] == 292
    widths = []

    def wrapper(x, a_stack, b_stack, idx, active):
        widths.append(b_stack.shape[-1])
        return ragged_grouped_lora_ref(x, a_stack, b_stack, idx, active)
    monkeypatch.setattr(L, "ragged_grouped_lora", wrapper)
    x = torch.from_numpy(np.random.RandomState(4).randn(
        B, S, cfg.d_model).astype(np.float32))
    idx = torch.from_numpy(inputs["adapter_idx"])
    got = L.lora_delta_dispatch(x, a, b, idx,
                                torch.arange(1, a.shape[0],
                                             dtype=torch.int32))
    assert widths == [296] and widths[0] % ALIGN == 0
    assert got.shape == (B, S, 292)
    assert rel(got, L.lora_delta(x, a, b, idx)) < 1e-6
