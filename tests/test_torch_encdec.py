"""The port's encoder-decoder slice (whisper) and its sequential SSM
functions against the reference on the CPU, on the same seeded numpy
inputs and converted weights (float32):

* ``flash_attention`` (bidirectional; causal with a window and a query
  offset), ``cross_attention``, the packed cross-attention (its grouped
  form and its per-token plain version), ``run_encoder``, ``encoder_kv``
  and ``cross_attn_sublayer`` on the reduced whisper, and ``ssd_forward``
  (from a live state, with ``valid_len`` and the boundary states) and
  ``ssd_decode_step`` on the reduced mamba2 with its adapter delta: each
  within 1e-5 of max |ref|;
* the reduced whisper engine against ``repro.serving.Engine`` through
  the base → aLoRA pipeline on audio (each request salted by its
  frames' digest), async submission on and off: identical tokens,
  ``n_cache_hit_tokens``, KV hits, misses and evictions, preemptions and
  step counts; a request on another audio under the same prompt reuses
  nothing; and under block pressure (preemptions) the same again, with
  one encode per admission, re-admissions included."""
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core.alora import AdapterSpec as JSpec
from repro.core.alora import init_adapter_weights as jax_adapter
from repro.core.alora import per_layer_adapters as jax_per_layer
from repro.core.alora import stack_adapters as jax_stack
from repro.kernels.ref import packed_cross_attention_ref as jax_packed_ref
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import ssm as JS
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro_torch.configs import get_reduced
from repro_torch.core.alora import (AdapterSpec, per_layer_adapters,
                                    stack_adapters)
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.models.convert import adapters_from_jax, params_from_jax
from repro_torch.serving import Engine, EngineConfig

# one intra-op thread: this file shares the CPU with the rest of the suite
torch.set_num_threads(1)

WHISPER = "whisper-large-v3"
INV = (7, 8, 9)
TOL = 1e-5


def _close(got, want):
    """max |got - want| within TOL of max |want|."""
    g, w = got.detach().float().numpy(), np.asarray(want, np.float32)
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= TOL * np.abs(w).max()


def _x(*shape, seed=0, scale=1.0):
    a = (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.fixture(scope="module")
def whisper():
    cfg_j, cfg = jax_reduced(WHISPER), get_reduced(WHISPER)
    # jitted: the same weights for both packages, drawn faster than eagerly
    pj = jax.jit(functools.partial(JM.init_params, cfg=cfg_j))(
        jax.random.key(0))
    params = params_from_jax(jax.tree.map(np.asarray, pj), cfg, "cpu")
    return cfg_j, cfg, pj, params


# ---------------------------------------------------------------------------
# model-level functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window,q_offset", [
    (False, 0, 0), (True, 0, 0), (True, 24, 0), (True, 16, 30)],
    ids=["bidirectional", "causal", "causal_window", "window_offset"])
def test_flash_attention(causal, window, q_offset):
    """GQA (H 4, KV 2) over 70 queries and 100 keys, the reference in
    blocks of 32 query and 32 key rows (its online softmax across key
    blocks)."""
    jq, tq = _x(2, 70, 4, 16, seed=1)
    jk, tk = _x(2, 100, 2, 16, seed=2)
    jv, tv = _x(2, 100, 2, 16, seed=3)
    want = JA.flash_attention(jq, jk, jv, causal=causal, window=window,
                              q_offset=q_offset, q_block=32, kv_block=32)
    _close(A.flash_attention(tq, tk, tv, causal=causal, window=window,
                             q_offset=q_offset), want)


def test_cross_attention():
    jq, tq = _x(3, 5, 4, 32, seed=4)
    jk, tk = _x(3, 64, 4, 32, seed=5)
    jv, tv = _x(3, 64, 4, 32, seed=6)
    _close(A.cross_attention(tq, tk, tv), JA.cross_attention(jq, jk, jv))


def test_packed_cross_attention():
    """Packed rows of three requests (a 5-row chunk, two decode rows,
    interleaved) over their own encoder K/V: the grouped form (K/V per
    request, no per-token copy) and the plain per-token form, each
    against the reference's per-token ``packed_cross_attention_ref``."""
    rows = np.array([1, 1, 1, 0, 1, 1, 2], np.int64)
    cols = np.array([0, 1, 2, 0, 3, 4, 0], np.int64)
    jq, tq = _x(7, 4, 32, seed=7)
    jk, tk = _x(3, 64, 2, 32, seed=8)          # (R, Se, KV, hd)
    jv, tv = _x(3, 64, 2, 32, seed=9)
    want = jax_packed_ref(jq, jk[rows], jv[rows])
    _close(A.packed_cross_attention_ref(tq, tk[rows], tv[rows]), want)
    got = A.packed_cross_attention(
        tq, tk.transpose(1, 2).contiguous(), tv.transpose(1, 2).contiguous(),
        torch.from_numpy(rows), torch.from_numpy(cols), 6)
    _close(got, want)


def test_encoder_and_cross_attention_sublayer(whisper):
    """``run_encoder`` on frames of one request, each decoder layer's
    ``encoder_kv`` of its output, and ``cross_attn_sublayer`` of a
    decoder chunk against them."""
    cfg_j, cfg, pj, params = whisper
    jf, tf = _x(1, cfg.encoder_seq_len, cfg.d_model, seed=10, scale=0.02)
    want_enc = jax.jit(JM._run_encoder, static_argnums=(1, 2))(
        pj["encoder"], cfg_j, JM.Runtime(), jf)
    enc = M.run_encoder(params["encoder"], cfg, tf)
    _close(enc, want_enc)
    jx, tx = _x(1, 9, cfg.d_model, seed=11)
    jlayers = [lp for _, lp in JM.iter_layers(pj, cfg_j)]
    for (_, lp), jlp in zip(M.iter_layers(params, cfg), jlayers):
        xk, xv = M.encoder_kv(lp, cfg, enc)
        jxk, jxv = JM.encoder_kv(jlp, cfg_j, want_enc)
        _close(xk, jxk)
        _close(xv, jxv)
        _close(M.cross_attn_sublayer(lp, cfg, tx, xk, xv),
               JM.cross_attn_sublayer(jlp, cfg_j, jx, jxk, jxv))


@pytest.fixture(scope="module")
def mamba2():
    """One reduced mamba2 SSM layer with a stack of two rank-8 adapters
    on its input projection, chunked at 16 tokens (the engine's block
    size)."""
    import dataclasses
    cfg_j, cfg = jax_reduced("mamba2-2.7b"), get_reduced("mamba2-2.7b")
    cfg_j = cfg_j.replace(ssm=dataclasses.replace(cfg_j.ssm, chunk_size=16))
    cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk_size=16))
    jlp = JS.init_ssm(jax.random.key(0), cfg_j, jnp.float32)
    lp = {k: torch.from_numpy(np.array(v)) for k, v in jlp.items()}
    draw = jax.jit(functools.partial(jax_adapter, cfg=cfg_j, rank=8))
    ads = [draw(jax.random.key(k)) for k in (5, 6)]
    jal = jax_per_layer(cfg_j, jax_stack(cfg_j, ads, 8))[0]
    al = per_layer_adapters(cfg, stack_adapters(cfg, [adapters_from_jax(
        jax.tree.map(np.asarray, a), cfg, "cpu") for a in ads], 8))[0]
    return cfg_j, cfg, jlp, lp, jal, al


def _ssm_inputs(cfg, B, S, seed):
    _, nh, ch = ssm.ssm_dims(cfg)
    s = cfg.ssm
    jx, tx = _x(B, S, cfg.d_model, seed=seed)
    jst, tst = _x(B, nh, s.state_dim, s.head_dim, seed=seed + 1, scale=0.3)
    jcv, tcv = _x(B, s.conv_width - 1, ch, seed=seed + 2)
    idx = np.random.RandomState(seed + 3).randint(0, 3, (B, S)).astype(
        np.int32)
    return (jx, jst, jcv, jnp.asarray(idx)), (tx, tst, tcv,
                                              torch.from_numpy(idx))


@pytest.mark.parametrize("valid_len", [None, 37], ids=["full", "valid_len"])
def test_ssd_forward(mamba2, valid_len):
    """A padded 48-token chunk (3 chunks of 16) from a live state and
    conv window, with the adapter delta: y, the final state and conv
    window, and the state and conv window at every chunk boundary."""
    cfg_j, cfg, jlp, lp, jal, al = mamba2
    (jx, jst, jcv, jidx), (tx, tst, tcv, tidx) = _ssm_inputs(cfg, 2, 48, 20)
    want = jax.jit(JS.ssd_forward, static_argnums=1, static_argnames=(
        "valid_len", "return_boundary_states"))(
        jlp, cfg_j, jx, jst, jcv, alora=jal, adapter_idx=jidx,
        valid_len=valid_len, return_boundary_states=True)
    got = ssm.ssd_forward(lp, cfg, tx, tst, tcv, alora=al, adapter_idx=tidx,
                          valid_len=valid_len, return_boundary_states=True)
    for g, w in zip(got[:3] + got[3], want[:3] + want[3]):
        _close(g, w)


def test_ssd_decode_step(mamba2):
    cfg_j, cfg, jlp, lp, jal, al = mamba2
    (jx, jst, jcv, jidx), (tx, tst, tcv, tidx) = _ssm_inputs(cfg, 4, 1, 30)
    want = jax.jit(JS.ssd_decode_step, static_argnums=1)(
        jlp, cfg_j, jx, jst, jcv, alora=jal, adapter_idx=jidx)
    got = ssm.ssd_decode_step(lp, cfg, tx, tst, tcv, alora=al,
                              adapter_idx=tidx)
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def audio(seed, cfg):
    """(Se, d) float32 frames, N(0, 0.02), and their digest."""
    fr = (np.random.RandomState(seed).randn(cfg.encoder_seq_len, cfg.d_model)
          * 0.02).astype(np.float32)
    return dict(frame_embeds=fr,
                salt=(hashlib.sha256(fr.tobytes()).hexdigest(),))


def audio_traffic(eng, cfg):
    """Two base requests, each on its own audio (prompts of 40); an aLoRA
    eval on each (x + y + invocation, same audio); then a base request
    with request 0's prompt on a third audio.  Returns (base + eval ids,
    the other-audio id)."""
    rng = np.random.RandomState(3)
    auds = [audio(s, cfg) for s in (10, 11, 12)]
    xs = [list(rng.randint(10, cfg.vocab_size, 40)) for _ in range(2)]
    base = [eng.submit(x, 6, **a) for x, a in zip(xs, auds)]
    eng.run_until_idle()
    evals = [eng.submit(x + eng.request(b).output_tokens + list(INV), 4,
                        adapter_name="uq", **a)
             for x, b, a in zip(xs, base, auds)]
    eng.run_until_idle()
    other = eng.submit(xs[0], 6, **auds[2])
    eng.run_until_idle()
    return base + evals, other


@pytest.fixture(scope="module")
def engines(whisper):
    """Build (reference, port) whisper engines of one EngineConfig on the
    converted weights and a rank-8 aLoRA adapter."""
    cfg_j, cfg, pj, params = whisper
    aj = jax_adapter(jax.random.key(7), cfg_j, 8)
    at = adapters_from_jax(jax.tree.map(np.asarray, aj), cfg, "cpu")

    def build(**kw):
        return (JEngine(cfg_j, pj, adapters=[(JSpec("uq", 8, INV), aj)],
                        engine_cfg=JEngineConfig(**kw)),
                Engine(cfg, params, device="cpu",
                       adapters=[(AdapterSpec("uq", 8, INV), at)],
                       engine_cfg=EngineConfig(**kw)))
    return build


def _same_run(eng, jeng, ids):
    for rid in ids:
        got, want = eng.request(rid), jeng.request(rid)
        assert got.output_tokens == want.output_tokens, rid
        assert got.n_cache_hit_tokens == want.n_cache_hit_tokens, rid
    for k in ("hits", "misses", "evictions"):
        assert getattr(eng.kv_mgr, k) == getattr(jeng.kv_mgr, k), k
    assert eng.preemptions == jeng.preemptions
    for k in ("mixed_step", "prefill_chunk", "decode_batch", "encode"):
        assert eng.runner.call_counts[k] == jeng.runner.call_counts[k], k
    assert sum(m.ref for m in eng.kv_mgr.meta) == 0
    assert eng.kv_mgr.num_free() == eng.kv_mgr.num_blocks
    # every admission encodes once, a preempted request's re-admission
    # too, and every run slot (with the encoder K/V it held) came back
    assert eng.runner.call_counts["encode"] == len(ids) + eng.preemptions
    assert sorted(eng._free_slots) == list(range(eng.ecfg.max_running))


@pytest.mark.parametrize("async_submission", [True, False],
                         ids=["async", "sync"])
def test_whisper_engine_matches_reference(engines, async_submission):
    jeng, eng = engines(async_submission=async_submission)
    ids, other = audio_traffic(eng, eng.cfg)
    assert (ids, other) == audio_traffic(jeng, jeng.cfg)
    _same_run(eng, jeng, ids + [other])
    bs = eng.ecfg.block_size
    for b, e in zip(ids[:2], ids[2:]):
        n = len(eng.request(b).prompt) + len(eng.request(b).output_tokens)
        assert eng.request(e).n_cache_hit_tokens == (n - 1) // bs * bs
    # another audio under the same prompt reuses none of its blocks
    assert eng.request(other).n_cache_hit_tokens == 0
    assert eng.request(other).output_tokens != \
        eng.request(ids[0]).output_tokens
    assert eng.runner.call_counts["encode"] == 5


def test_whisper_engine_under_block_pressure(engines):
    """Six blocks of 16 for three 40-token requests: the engine preempts,
    re-admission re-encodes, and the runs agree."""
    jeng, eng = engines(num_blocks=6, admission_policy="fcfs")
    rng = np.random.RandomState(5)
    cfg = eng.cfg
    for e in (jeng, eng):
        for i in range(3):
            e.submit(list(rng.randint(10, cfg.vocab_size, 40)), 12,
                     **audio(20 + i, cfg))
        rng = np.random.RandomState(5)
    for e in (jeng, eng):
        e.run_until_idle()
    assert eng.preemptions > 0
    assert eng.runner.call_counts["encode"] > 3
    _same_run(eng, jeng, [0, 1, 2])


def test_init_ssm_state(mamba2):
    """Zero states of the reference's shapes and dtypes."""
    cfg_j, cfg = mamba2[:2]
    for got, want in zip(ssm.init_ssm_state(cfg, 3, "cpu"),
                         JS.init_ssm_state(cfg_j, 3)):
        assert got.shape == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert not got.any()
