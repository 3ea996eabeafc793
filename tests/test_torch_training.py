"""The port's training substrate (``repro_torch.training``) against the
reference's on the same seeded numpy inputs and the same weights (the
port's, converted with ``convert.params_to_jax``): the schedule, one
``adamw_update`` on a reduced-granite tree with the same gradients
(which catches the weight-decay rule, decided on the reference's stacked
shapes), ``chunked_ce_loss`` at S = 128 and 129 (the tail it drops), one
``make_train_step`` on granite, mamba2, granite-moe (aux), phi-3-vision
(patch prefix) and whisper (audio) — loss, ce, aux, grad norm and lr
within 1e-5 relative, moments within 1e-5 of each leaf's max |ref| and
params within 1e-5 of the tree's — the training ``Runtime`` (remat and
flash_remat on ≡ off), the data pipeline bit for bit, checkpoints, the
CLI and the example, and the no-backward rule of the adapted
projections' kernels on a card."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import training as JT
from repro.configs import get_reduced as jax_reduced
from repro.models import model as JM
from repro_torch import training as T
from repro_torch.common import tree_at as at
from repro_torch.common import tree_leaves
from repro_torch.common import tree_paths as _paths
from repro_torch.configs import get_reduced
from repro_torch.core.alora import init_adapter_weights, stack_adapters
from repro_torch.examples import train_small
from repro_torch.kernels import alora_qkv, ragged_lora, ssd_chunk
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.training.optimizer import adamw_state_from_jax, decays

torch.set_num_threads(1)
TOL = 1e-5


def model(arch, seed=0):
    cfg = get_reduced(arch)
    params = M.init_params(torch.Generator().manual_seed(seed), cfg,
                           device="cpu")
    jp = jax.tree.map(jnp.asarray, params_to_jax(params, cfg))
    return cfg, jax_reduced(arch), params, jp


def rel(got, want) -> float:
    g = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


# ---------------------------------------------------------------------------
# optimizer and loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 1, 5, 10, 55, 99, 100, 150])
def test_lr_at_matches_the_reference(step):
    cfg = T.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                        min_lr_frac=0.1)
    jcfg = JT.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
    got, want = float(T.lr_at(cfg, step)), float(JT.lr_at(jcfg, step))
    assert abs(got - want) <= 1e-7 * max(abs(want), 1e-30)


def test_adamw_update_matches_the_reference_and_its_decay_rule():
    """One step on the reduced granite's tree with the same gradients:
    params and moments within 1e-5 of each leaf's max |ref|.  Every
    per-layer leaf is decayed (the reference's are stacked, hence of two
    or more dimensions), ``final_norm`` is not; the literal ``ndim >= 2``
    rule on the port's per-layer layout would leave ``ln1`` about 1e-3
    away."""
    cfg, cfg_j, tp, jp = model("granite-3.2-8b")
    ocfg = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    rng = np.random.RandomState(3)
    jg = jax.tree.map(lambda a: jnp.asarray(
        rng.randn(*a.shape).astype(np.float32) * 1e-2), jp)
    jnew, jst, jstats = jax.jit(JT.adamw_update, static_argnums=0)(
        JT.AdamWConfig(**ocfg), jg, JT.init_adamw(jp), jp)
    tg = params_from_jax(jax.tree.map(np.asarray, jg), cfg, "cpu")
    new, st, stats = T.adamw_update(T.AdamWConfig(**ocfg), tg,
                                    T.init_adamw(tp), tp)
    want = params_from_jax(jax.tree.map(np.asarray, jnew), cfg, "cpu")
    wst = adamw_state_from_jax(jax.tree.map(np.asarray, jst), cfg, "cpu")
    assert int(st.step) == int(jst.step) == 1
    for tree, ref in ((new, want), (st.mu, wst.mu), (st.nu, wst.nu)):
        for path, a in _paths(tree):
            assert rel(a, at(ref, path).numpy()) < TOL, path
    for k in ("grad_norm", "lr"):
        assert abs(float(stats[k]) - float(jstats[k])) <= \
            TOL * abs(float(jstats[k]))
    assert decays(("layers", 0, "ln1"), tp["layers"][0]["ln1"])
    assert decays(("encoder", "layers", 0, "ln2"), torch.ones(4))
    assert not decays(("final_norm",), tp["final_norm"])
    assert not decays(("encoder", "final_norm"), torch.ones(4))
    assert decays(("embed", "tok"), tp["embed"]["tok"])


def test_adamw_descends_a_quadratic_and_reports_the_raw_norm():
    cfg = T.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200,
                        weight_decay=0.0, grad_clip=10.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = T.init_adamw(params)
    for _ in range(150):
        params, state, _ = T.adamw_update(cfg, {"w": 2 * params["w"]},
                                          state, params)
    assert params["w"].abs().max() < 0.05
    _, _, stats = T.adamw_update(
        T.AdamWConfig(lr=1.0, warmup_steps=0, weight_decay=0.0),
        {"w": torch.full((3,), 1e6)}, T.init_adamw({"w": torch.zeros(3)}),
        {"w": torch.zeros(3)})
    assert float(stats["grad_norm"]) > 1e5


@pytest.mark.parametrize("S", [128, 129])
def test_chunked_ce_loss_matches_the_reference(S):
    """At S = 129 with chunk 64 the last position is not scored, as in the
    reference."""
    cfg, cfg_j, tp, jp = model("granite-3.2-8b")
    rng = np.random.RandomState(S)
    h = rng.randn(2, S, cfg.d_model).astype(np.float32)
    labels = rng.randint(0, cfg.vocab_size, (2, S)).astype(np.int32)
    mask = (rng.rand(2, S) > 0.2).astype(np.float32)
    got = T.chunked_ce_loss(tp, cfg, torch.from_numpy(h),
                            torch.from_numpy(labels), torch.from_numpy(mask),
                            chunk=64)
    want = JT.chunked_ce_loss(jp, cfg_j, jnp.asarray(h), jnp.asarray(labels),
                              jnp.asarray(mask), chunk=64)
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))
    if S == 129:
        mask[:, -1] = 0.0               # the dropped tail: no change
        again = T.chunked_ce_loss(tp, cfg, torch.from_numpy(h),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(mask), chunk=64)
        assert float(again) == float(got)


# ---------------------------------------------------------------------------
# one train step against the reference's
# ---------------------------------------------------------------------------
def batch_for(cfg, B=2, S=32, seed=1):
    rng = np.random.RandomState(seed)
    b = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "mask": np.ones((B, S), np.float32)}
    n = {"audio": cfg.encoder_seq_len, "vision": cfg.num_patches}.get(
        cfg.frontend)
    if n is not None:
        b["extra_embeds"] = (rng.randn(B, n, cfg.d_model) * 0.05).astype(
            np.float32)
    return b


@pytest.fixture(scope="module")
def steps():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg, cfg_j, tp, jp = model(arch)
            batch = batch_for(cfg)
            js, jstats = jax.jit(JT.make_train_step(
                cfg_j, JT.AdamWConfig(total_steps=10), JM.Runtime(),
                loss_chunk=16))(JT.init_train_state(jp),
                                {k: jnp.asarray(v) for k, v in batch.items()})
            ts, stats = T.make_train_step(
                cfg, T.AdamWConfig(total_steps=10), M.Runtime(),
                loss_chunk=16)(T.init_train_state(tp), batch)
            cache[arch] = (cfg, ts, stats, js, jstats)
        return cache[arch]
    return get


STEP_ARCHS = ["granite-3.2-8b", "mamba2-2.7b", "granite-moe-1b-a400m",
              "phi-3-vision-4.2b", "whisper-large-v3"]


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_stats(steps, arch):
    cfg, _, stats, _, jstats = steps(arch)
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        assert abs(float(stats[k]) - float(jstats[k])) <= \
            TOL * max(abs(float(jstats[k])), 1e-6), k
    assert (float(jstats["aux"]) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_params_and_moments(steps, arch):
    cfg, ts, _, js, _ = steps(arch)
    want = params_from_jax(jax.tree.map(np.asarray, js.params), cfg, "cpu")
    scale = max(float(w.abs().max()) for w in tree_leaves(want))
    for path, a in _paths(ts.params):
        assert float((a - at(want, path)).abs().max()) <= TOL * scale, path
    wst = adamw_state_from_jax(jax.tree.map(np.asarray, js.opt), cfg, "cpu")
    for tree, ref in ((ts.opt.mu, wst.mu), (ts.opt.nu, wst.nu)):
        for path, a in _paths(tree):
            assert rel(a, at(ref, path).numpy()) < TOL, path


@pytest.mark.parametrize("arch", ["granite-3.2-8b", "zamba2-2.7b"])
def test_remat_and_flash_remat_change_no_result(arch):
    """The training Runtime: layer remat and the recomputing attention
    backward on give the step's loss and gradients of them off."""
    cfg, _, tp, _ = model(arch)
    batch = batch_for(cfg, S=40)
    outs = []
    for rt in (M.Runtime(), M.Runtime(remat=True, flash_remat=True,
                                      q_block=16, kv_block=16)):
        params = {k: v for k, v in tp.items()}
        params = params_from_jax(params_to_jax(tp, cfg), cfg, "cpu")
        ts, stats = T.make_train_step(cfg, T.AdamWConfig(total_steps=10),
                                      rt, loss_chunk=16)(
            T.init_train_state(params), batch)
        outs.append((stats, ts.opt.mu))
    (s0, m0), (s1, m1) = outs
    for k in ("loss", "grad_norm"):
        assert abs(float(s0[k]) - float(s1[k])) <= TOL * abs(float(s0[k]))
    for path, a in _paths(m1):
        assert rel(a, at(m0, path).numpy()) < TOL, path


def test_loss_decreases_on_a_repeated_batch():
    """The reference's ``test_loss_decreases_on_repeated_batch``."""
    cfg, _, tp, _ = model("granite-3.2-8b")
    step = T.make_train_step(cfg, T.AdamWConfig(lr=1e-3, warmup_steps=2,
                                                total_steps=30),
                             M.Runtime(), loss_chunk=16)
    batch = T.SyntheticDataset(T.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)).batch(0)
    state, losses = T.init_train_state(tp), []
    for _ in range(15):
        state, stats = step(state, batch)
        losses.append(float(stats["loss"]))
    assert losses[-1] < losses[0] - 0.5


# ---------------------------------------------------------------------------
# data, checkpoints, entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 5])
def test_synthetic_batches_are_the_references_bit_for_bit(step):
    kw = dict(vocab_size=100, seq_len=40, global_batch=3, seed=3,
              mean_doc_len=8)
    got = T.SyntheticDataset(T.DataConfig(**kw)).batch(step)
    want = JT.SyntheticDataset(JT.DataConfig(**kw)).batch(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_checkpoint_round_trip_and_shape_mismatch(tmp_path):
    cfg, _, tp, _ = model("zamba2-2.7b")
    path = os.path.join(tmp_path, "ckpt.npz")
    T.save_checkpoint(path, tp, step=7)
    assert T.checkpoint_step(path) == 7
    like = {k: v for k, v in tp.items()}
    like = M.init_params(torch.Generator().manual_seed(9), cfg, device="cpu")
    back = T.restore_checkpoint(path, like)
    for a, b in zip(tree_leaves(back), tree_leaves(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    T.save_checkpoint(path, {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="w"):
        T.restore_checkpoint(path, {"w": torch.zeros(4)})


def test_bf16_checkpoint_keeps_its_values(tmp_path):
    path = os.path.join(tmp_path, "b.npz")
    w = torch.randn(5, 3).to(torch.bfloat16)
    T.save_checkpoint(path, {"layers": [{"w": w}]})
    back = T.restore_checkpoint(path, {"layers": [{"w": torch.zeros_like(w)}]})
    assert back["layers"][0]["w"].dtype == torch.bfloat16
    assert torch.equal(back["layers"][0]["w"], w)


def test_launch_train_main_on_the_cpu(tmp_path, capsys):
    ckpt = os.path.join(tmp_path, "c.npz")
    stats = launch_train.main(["--device", "cpu", "--arch", "mamba2-2.7b",
                               "--steps", "3", "--batch", "2", "--seq",
                               "16", "--log-every", "1", "--ckpt", ckpt])
    assert len(stats) == 3
    assert all(np.isfinite(s["loss"]) for s in stats)
    out = capsys.readouterr().out
    assert "training reduced mamba2-2.7b-reduced" in out
    assert "step     2 loss=" in out and "saved checkpoint" in out
    assert T.checkpoint_step(ckpt) == 3


def test_train_small_example_on_the_cpu(capsys):
    stats = train_small.main(device="cpu", argv=[
        "--arch", "phi-3-vision-4.2b", "--steps", "2", "--batch", "2",
        "--seq", "16"])
    assert len(stats) == 2 and np.isfinite(stats[-1]["loss"])
    assert "step     1 loss=" in capsys.readouterr().out


class _FlaggedCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: the kernel wrappers take
    their card branch on it, which here must raise before any launch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_card(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_FlaggedCuda, t, t.requires_grad)


@pytest.mark.parametrize("name", ["alora_qkv", "ragged_grouped_lora",
                                  "ragged_grouped_lora_qkv",
                                  "ssd_chunk_scan"])
def test_card_kernels_under_grad_raise(name):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 16), generator=g, requires_grad=True)
    a = torch.randn((3, 16, 8), generator=g)
    b = torch.randn((3, 8, 16), generator=g)
    idx = torch.zeros(4, dtype=torch.int32)
    slots = torch.arange(1, 3, dtype=torch.int32)
    calls = {
        "alora_qkv": lambda x: alora_qkv.alora_qkv(
            x, torch.randn(16, 16), a, b, idx),
        "ragged_grouped_lora": lambda x: ragged_lora.ragged_grouped_lora(
            x, a, b, idx, slots),
        "ragged_grouped_lora_qkv": lambda x:
            ragged_lora.ragged_grouped_lora_qkv(x, (a, b), (a, b), (a, b),
                                                idx, slots),
        "ssd_chunk_scan": lambda x: ssd_chunk.ssd_chunk_scan(
            x.reshape(1, 4, 2, 8), torch.zeros(1, 4, 2, 16),
            torch.zeros(1, 4, 2, 16), torch.zeros(1, 4, 2),
            torch.zeros(1, 4, 2)),
    }
    with pytest.raises(RuntimeError, match=f"^{name}: .*no backward"):
        calls[name](_on_card(x * 1.0))


def test_adapted_forward_full_under_grad_raises_on_a_card(monkeypatch):
    """``forward_full`` with adapters, grad enabled, on a CUDA-flagged
    path: the fused aLoRA projection raises naming its kernel (no output
    without a ``grad_fn``); under ``torch.no_grad`` the same call runs."""
    cfg, _, tp, _ = model("granite-3.2-8b")
    w = init_adapter_weights(torch.Generator().manual_seed(5), cfg, 8,
                             device="cpu")
    st = stack_adapters(cfg, [w], 8)
    real = L.alora_qkv

    def flagged(x, *rest):
        if x.requires_grad:
            return real(_on_card(x), *rest)
        return real(x, *rest)
    monkeypatch.setattr(L, "alora_qkv", flagged)
    toks = torch.zeros((1, 8), dtype=torch.long)
    idx = torch.ones((1, 8), dtype=torch.int32)
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    with pytest.raises(RuntimeError, match="^alora_qkv: .*no backward"):
        M.forward_full(tp, cfg, toks, adapters=st, adapter_idx=idx)
    with torch.no_grad():
        h, _, _ = M.forward_full(tp, cfg, toks, adapters=st,
                                 adapter_idx=idx)
    assert h.grad_fn is None and torch.isfinite(h).all()
