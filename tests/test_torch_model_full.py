"""The port's full-sequence model (``repro_torch.models.model``:
``forward_full``, ``prefill_to_decode_caches``, ``decode_step``,
``init_decode_caches``) and the dense decode-cache attention functions
(``models.attention``: ``decode_attention``, ``quantize_kv``,
``dequantize_kv``, ``write_kv_cache``) against the reference on the same
seeded numpy inputs and the same weights (the port's, converted with
``convert.params_to_jax``), on the reduced float32 config of every
family: hidden states, aux, caches and logits within 1e-5 of max |ref|.
starcoder2 runs 150 tokens past its 128-token window (the decode cache
is a ring buffer).  Then the reference's aLoRA semantics
(``tests/test_alora_semantics.py``) on the port, int8 decode caches, and
the port's engine emitting the port's ``decode_step`` greedy tokens
(``tests/test_engine.py``'s dense-reference check).

On the CPU every kernel wrapper runs its plain version; the SSM layers of
a no-grad ``forward_full`` take the dense scan's route
(``ssm.ssd_forward``'s rule), whose plain version is the token
recurrence."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch.configs import get_reduced
from repro_torch.core.alora import (AdapterSpec, init_adapter_weights,
                                    stack_adapters)
from repro_torch.kernels import ssd_chunk
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm as S_
from repro_torch.models.convert import (adapters_from_jax, caches_to_jax,
                                        decode_caches_from_jax,
                                        params_to_jax)
from repro_torch.serving import Engine

torch.set_num_threads(1)

ARCHS = ["granite-3.2-8b", "mamba2-2.7b", "zamba2-2.7b", "whisper-large-v3",
         "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b", "phi-3-vision-4.2b",
         "starcoder2-3b", "stablelm-12b", "minitron-4b", "nemotron-4-15b"]
TOL = 1e-5
B, S, MAX_LEN = 2, 24, 256
# the reference's passes, compiled once per configuration (faster than
# their eager scans)
jax_forward = jax.jit(JM.forward_full, static_argnums=(1, 3),
                      static_argnames=("return_caches",))
jax_decode = jax.jit(JM.decode_step, static_argnums=(1, 5))


def rel(got, want) -> float:
    g = np.asarray(got.detach() if torch.is_tensor(got) else got,
                   np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))


def jtree(np_tree):
    return jax.tree.map(jnp.asarray, np_tree)


def model(arch, seed=0):
    cfg = get_reduced(arch)
    params = M.init_params(torch.Generator().manual_seed(seed), cfg,
                           device="cpu")
    return cfg, jax_reduced(arch), params, jtree(params_to_jax(params, cfg))


def extra_for(cfg, rng):
    n = {"audio": cfg.encoder_seq_len, "vision": cfg.num_patches}.get(
        cfg.frontend)
    return None if n is None else \
        (rng.randn(B, n, cfg.d_model) * 0.05).astype(np.float32)


def stacked_adapter(cfg, seed=5, rank=8):
    w = init_adapter_weights(torch.Generator().manual_seed(seed), cfg, rank,
                             device="cpu")
    st = stack_adapters(cfg, [w], rank)
    return st, jtree(jax.tree.map(lambda t: t.numpy(), st))


@pytest.fixture(scope="module")
def runs():
    """Per arch: both packages' forward_full (half the positions on an
    adapter, with caches), then prefill → decode of one token on the
    adapter; computed once for every test below."""
    cache = {}

    def get(arch):
        if arch in cache:
            return cache[arch]
        cfg, cfg_j, tp, jp = model(arch)
        seq = 150 if arch == "starcoder2-3b" else S     # past the window
        rng = np.random.RandomState(1)
        toks = rng.randint(0, cfg.vocab_size, (B, seq)).astype(np.int32)
        ex = extra_for(cfg, rng)
        aidx = np.where(np.arange(seq) >= seq // 2, 1, 0)[None] \
            .repeat(B, 0).astype(np.int32)
        tst, jst = stacked_adapter(cfg)
        jex = None if ex is None else jnp.asarray(ex)
        tex = None if ex is None else torch.from_numpy(ex)
        hj, auxj, cj = jax_forward(
            jp, cfg_j, jnp.asarray(toks), JM.Runtime(), extra_embeds=jex,
            adapters=jst, adapter_idx=jnp.asarray(aidx), return_caches=True)
        with torch.no_grad():
            ht, auxt, ct = M.forward_full(
                tp, cfg, torch.from_numpy(toks), extra_embeds=tex,
                adapters=tst, adapter_idx=torch.from_numpy(aidx),
                return_caches=True)
        npre = seq + (cfg.num_patches if cfg.frontend == "vision" else 0)
        tok = rng.randint(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        on = np.ones((B, 1), np.int32)
        dj = JM.prefill_to_decode_caches(cfg_j, cj, npre, MAX_LEN)
        lj, dj = jax_decode(jp, cfg_j, jnp.asarray(tok), dj,
                            jnp.int32(npre), JM.Runtime(), adapters=jst,
                            adapter_idx=jnp.asarray(on))
        with torch.no_grad():
            dt = M.prefill_to_decode_caches(cfg, ct, npre, MAX_LEN)
            lt, dt = M.decode_step(tp, cfg, torch.from_numpy(tok), dt, npre,
                                   adapters=tst,
                                   adapter_idx=torch.from_numpy(on))
        cache[arch] = dict(cfg=cfg, hidden=(ht, hj), aux=(auxt, auxj),
                           caches=(caches_to_jax(ct, cfg), cj),
                           logits=(lt, lj), decode=(caches_to_jax(dt, cfg),
                                                    dj))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_full_hidden_and_aux(runs, arch):
    r = runs(arch)
    ht, hj = r["hidden"]
    assert rel(ht, hj) < TOL
    auxt, auxj = r["aux"]
    assert auxt.dtype == torch.float32 and auxt.dim() == 0
    assert abs(float(auxt) - float(auxj)) <= TOL * max(abs(float(auxj)),
                                                       1e-3)
    if r["cfg"].moe is not None:
        assert float(auxj) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_full_caches(runs, arch):
    got, want = runs(arch)["caches"]
    assert set(got) == set(want)
    for seg in want:
        assert set(got[seg]) == set(want[seg])
        for k in want[seg]:
            assert rel(got[seg][k], want[seg][k]) < TOL, (seg, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_step(runs, arch):
    r = runs(arch)
    lt, lj = r["logits"]
    assert lt.shape == lj.shape
    assert rel(lt, lj) < TOL
    got, want = r["decode"]
    for seg in want:
        for k in want[seg]:
            assert rel(got[seg][k], want[seg][k]) < TOL, (seg, k)


@pytest.mark.parametrize("arch", ["granite-3.2-8b", "zamba2-2.7b",
                                  "whisper-large-v3"])
def test_decode_caches_convert_both_ways(arch):
    """Reference decode caches → the port's per-layer list → back."""
    cfg_j = jax_reduced(arch)
    cj = jax.tree.map(np.asarray, JM.init_decode_caches(cfg_j, 2, 16))
    rng = np.random.RandomState(0)
    cj = jax.tree.map(lambda a: rng.randn(*a.shape).astype(a.dtype), cj)
    cfg = get_reduced(arch)
    ct = decode_caches_from_jax(cj, cfg, device="cpu")
    assert len(ct) == cfg.num_layers
    fresh = M.init_decode_caches(cfg, 2, 16, device="cpu")
    for got, zero in zip(ct, fresh):
        assert {k: v.shape for k, v in got.items()} == \
            {k: v.shape for k, v in zero.items()}
    back = caches_to_jax(ct, cfg)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(cj)):
        np.testing.assert_array_equal(a, b)


def test_prefill_decode_matches_the_full_forward():
    """The reference's ``test_prefill_decode_consistency`` on the port:
    prefill S - 1 tokens, decode token S, equal to the teacher-forced
    forward at position S - 1 (on the reduced zamba2: SSM and attention
    layers)."""
    cfg, _, tp, _ = model("zamba2-2.7b")
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (B, 33)).astype(np.int64))
    with torch.no_grad():
        h, _, _ = M.forward_full(tp, cfg, toks)
        want = M.logits_for(tp, cfg, h)[:, -1]
        _, _, pc = M.forward_full(tp, cfg, toks[:, :32], return_caches=True)
        dc = M.prefill_to_decode_caches(cfg, pc, 32, 128)
        got, _ = M.decode_step(tp, cfg, toks[:, 32:], dc, 32)
    assert rel(got[:, 0], want) < 2e-5


def test_kv_cache_quant_decode_argmax_preserved():
    """The reference's ``test_kv_quant_decode_argmax_preserved`` on the
    port (reduced stablelm, int8 caches from ``init_decode_caches``), and
    the port's int8 decode logits against the reference's within its
    2e-2."""
    cfg, cfg_j, tp, jp = model("stablelm-12b")
    rt, rt_j = M.Runtime(kv_cache_quant=True), JM.Runtime(
        kv_cache_quant=True)
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size,
                                            (B, 20)).astype(np.int32)
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        h, _, _ = M.forward_full(tp, cfg, tt)
        want = M.logits_for(tp, cfg, h)[:, -1]
        caches = M.init_decode_caches(cfg, B, 32, rt, device="cpu")
        assert caches[0]["k"].dtype == torch.int8
        assert caches[0]["ks"].dtype == torch.float32
        for t in range(20):
            lg, caches = M.decode_step(tp, cfg, tt[:, t:t + 1], caches, t,
                                       rt)
        assert rel(lg[:, 0], want) < 0.02
        assert torch.equal(lg[:, 0].argmax(-1), want.argmax(-1))
    jc = JM.init_decode_caches(cfg_j, B, 32, rt_j)
    for t in range(20):
        lj, jc = jax_decode(jp, cfg_j, jnp.asarray(toks[:, t:t + 1]), jc,
                            jnp.int32(t), rt_j)
    assert rel(lg, lj) < 0.02


# ---------------------------------------------------------------------------
# the dense decode-cache functions
# ---------------------------------------------------------------------------
def test_quantize_kv_is_bit_equal_and_round_trips():
    x = np.random.RandomState(0).randn(4, 8, 2, 32).astype(np.float32)
    x[0, 0, 0] = 0.0                                     # a zero row: scale 1
    x[1, 2, 1, :4] = [0.5, -0.5, 1.5, 2.5]               # halves: to even
    q, s = A.quantize_kv(torch.from_numpy(x))
    qj, sj = JA.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    back = A.dequantize_kv(q, s, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JA.dequantize_kv(qj, sj, jnp.float32)))
    assert rel(back, x) < 0.01
    # round half to even on exact halves of the scale
    h = torch.tensor([[[0.5, 1.5, 2.5, -0.5, 127.0]]])
    qh, _ = A.quantize_kv(h)
    assert qh.tolist() == [[[0, 2, 2, 0, 127]]]


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_and_write_kv_cache(window, per_row):
    rng = np.random.RandomState(window + 2 * per_row)
    Bq, Smax, H, KV, hd = 3, 12, 4, 2, 16
    kc = rng.randn(Bq, Smax, KV, hd).astype(np.float32)
    vc = rng.randn(Bq, Smax, KV, hd).astype(np.float32)
    kn = rng.randn(Bq, 1, KV, hd).astype(np.float32)
    vn = rng.randn(Bq, 1, KV, hd).astype(np.float32)
    q = rng.randn(Bq, 1, H, hd).astype(np.float32)
    pos = np.array([3, 7, 9], np.int32) if per_row else 7
    kj, vj = JA.write_kv_cache(jnp.asarray(kc), jnp.asarray(vc),
                               jnp.asarray(kn), jnp.asarray(vn),
                               jnp.asarray(pos), window=window)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = A.write_kv_cache(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                           torch.from_numpy(pos) if per_row else pos,
                           window=window)
    assert got[0] is tk and got[1] is tv                  # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(vj))
    n = pos + 1
    oj = JA.decode_attention(jnp.asarray(q), kj, vj, jnp.asarray(n),
                             window=window)
    ot = A.decode_attention(torch.from_numpy(q), tk, tv,
                            torch.from_numpy(n) if per_row else n,
                            window=window)
    assert rel(ot, oj) < TOL


# ---------------------------------------------------------------------------
# aLoRA semantics (the reference's tests/test_alora_semantics.py)
# ---------------------------------------------------------------------------
def test_pre_activation_equals_base_and_kv_bit_exact():
    cfg, _, tp, _ = model("granite-3.2-8b")
    st, _ = stacked_adapter(cfg)
    inv = 16
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (B, 24)))
    aidx = (torch.arange(24) >= inv).to(torch.int32)[None].repeat(B, 1)
    with torch.no_grad():
        hb, _, cb = M.forward_full(tp, cfg, toks, return_caches=True)
        ha, _, ca = M.forward_full(tp, cfg, toks, adapters=st,
                                   adapter_idx=aidx, return_caches=True)
    assert torch.equal(ha[:, :inv], hb[:, :inv])
    for lb, la in zip(cb, ca):
        assert torch.equal(lb["k"][:, :inv], la["k"][:, :inv])
    assert (cb[0]["k"][:, inv:] - ca[0]["k"][:, inv:]).abs().max() > 0


def test_full_activation_equals_vanilla_lora():
    cfg, _, tp, _ = model("granite-3.2-8b")
    st, _ = stacked_adapter(cfg)
    al = M.per_layer_adapters(cfg, st)[0]
    lp = tp["layers"][0]
    x = torch.randn((B, 16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    on = torch.ones((B, 16), dtype=torch.int32)
    q1, _, _ = L.qkv_project(lp["attn"], cfg, x, al, on)
    wq = lp["attn"]["wq"] + al["aq"][1] @ al["bq"][1]
    q2 = (x @ wq).reshape(B, 16, cfg.num_heads, cfg.head_dim)
    torch.testing.assert_close(q1, q2, rtol=2e-5, atol=2e-5)


def test_mixed_batch_rows_independent():
    cfg, _, tp, _ = model("granite-3.2-8b")
    st, _ = stacked_adapter(cfg)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 16)))
    aidx = torch.stack([torch.zeros(16, dtype=torch.int32),
                        torch.ones(16, dtype=torch.int32)])
    with torch.no_grad():
        hm, _, _ = M.forward_full(tp, cfg, toks, adapters=st,
                                  adapter_idx=aidx)
        hb, _, _ = M.forward_full(tp, cfg, toks)
    assert torch.equal(hm[0], hb[0])
    assert (hm[1] - hb[1]).abs().max() > 0


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_pre_activation_state_identical(arch):
    cfg, _, tp, _ = model(arch)
    st, _ = stacked_adapter(cfg)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (1, 32)))
    zero = torch.zeros((1, 32), dtype=torch.int32)
    with torch.no_grad():
        _, _, cb = M.forward_full(tp, cfg, toks, return_caches=True)
        _, _, ca = M.forward_full(tp, cfg, toks, adapters=st,
                                  adapter_idx=zero, return_caches=True)
    n = 0
    for lb, la in zip(cb, ca):
        if "ssm" in lb:
            assert torch.equal(lb["ssm"], la["ssm"])
            n += 1
    assert n == sum(k == "ssm" for k in cfg.pattern())


def test_no_grad_ssm_forward_takes_the_dense_scan(monkeypatch):
    """``forward_full``'s SSM layers: the dense scan once per layer
    without a gradient, never under one."""
    cfg, _, tp, _ = model("mamba2-2.7b")
    calls = []
    real = ssd_chunk.ssd_chunk_scan

    def counted(*args):
        calls.append(args[0].shape)
        return real(*args)
    monkeypatch.setattr(S_, "ssd_chunk_scan", counted)
    toks = torch.zeros((1, 8), dtype=torch.long)
    with torch.no_grad():
        M.forward_full(tp, cfg, toks)
    assert len(calls) == cfg.num_layers
    for p in tp["layers"][0]["ssm"].values():
        p.requires_grad_(True)
    h, _, _ = M.forward_full(tp, cfg, toks)
    assert len(calls) == cfg.num_layers and h.requires_grad


# ---------------------------------------------------------------------------
# the engine against the full-sequence model
# ---------------------------------------------------------------------------
def test_engine_matches_the_decode_step_tokens():
    """The reference's ``test_engine_matches_dense_reference`` on the
    port: the port's engine (paged cache, mixed step) emits the greedy
    tokens of the port's forward_full → prefill_to_decode_caches →
    decode_step."""
    cfg, _, tp, _ = model("granite-3.2-8b")
    prompt = list(np.random.RandomState(0).randint(10, 500, 50))
    with torch.no_grad():
        h, _, pc = M.forward_full(tp, cfg, torch.tensor([prompt]),
                                  return_caches=True)
        ref = [int(M.logits_for(tp, cfg, h)[0, -1].argmax())]
        dc = M.prefill_to_decode_caches(cfg, pc, len(prompt), 256)
        pos = len(prompt)
        for _ in range(7):
            lg, dc = M.decode_step(tp, cfg, torch.tensor([[ref[-1]]]), dc,
                                   pos)
            ref.append(int(lg[0, 0].argmax()))
            pos += 1
    w = init_adapter_weights(torch.Generator().manual_seed(7), cfg, 8,
                             device="cpu")
    eng = Engine(cfg, tp, adapters=[(AdapterSpec(
        "uq", rank=8, invocation_tokens=(7, 8, 9)), w)], device="cpu")
    rid = eng.submit(prompt, 8)
    eng.run_until_idle()
    assert eng.request(rid).output_tokens == ref


def test_adapters_convert_like_the_reference_stack():
    """A stacked adapter tree converts from the reference's layout to the
    one ``forward_full`` slices per layer."""
    cfg = get_reduced("zamba2-2.7b")
    st, jst = stacked_adapter(cfg)
    back = adapters_from_jax(jax.tree.map(np.asarray, jst), cfg, "cpu")
    for a, b in zip(M.per_layer_adapters(cfg, st),
                    M.per_layer_adapters(cfg, back)):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k])


def test_runtime_accepts_mesh_fields():
    """``Runtime`` takes the reference's mesh fields; ``window_override``
    sizes the decode ring buffer as the reference's
    ``init_decode_caches`` under ``Runtime(window_override=...)``."""
    rt = M.Runtime(mesh={"data": 1, "model": 2}, moe_impl="expert_parallel",
                   window_override=8, batch_axes=("data",),
                   capacity_factor=2.0, context_parallel=False,
                   shard_activations=True, sequence_parallel=True)
    cfg = get_reduced("granite-3.2-8b")
    assert M.effective_window(cfg, rt) == 8
    assert M.effective_window(cfg) == 0
    ref = JM.init_decode_caches(jax_reduced("granite-3.2-8b"), 2, 32,
                                JM.Runtime(window_override=8))
    got = M.init_decode_caches(cfg, 2, 32, M.Runtime(window_override=8),
                               device="cpu")
    assert tuple(got[0]["k"].shape) == ref["seg0"]["k"].shape[2:]
    with pytest.raises(ValueError, match="moe impl"):
        M.Runtime(moe_impl="scatter")
    with pytest.raises(ValueError, match="model axis"):
        M.Runtime(mesh={"model": 2}, model_axis="tp")
    with pytest.raises(TypeError):
        M.Runtime(skip_masked_blocks=True)
    M.Runtime(remat=True, flash_remat=True, kv_cache_quant=True)


