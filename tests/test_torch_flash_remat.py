"""``models.attention.flash_attention_remat`` (an ``autograd.Function``
whose backward recomputes the probabilities one (q block, kv block) tile
at a time) against ``jax.grad`` of the reference's
``flash_attention_remat`` (a ``jax.custom_vjp``) and against autograd
through the port's own ``flash_attention``, on the same seeded inputs:
the output and the gradients of q, k and v within 1e-5 of max |ref|.
Cases: causal, windowed, bidirectional, GQA, S off the blocks, and a
``q_offset`` (a chunk continuing after earlier keys)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.models import attention as A

torch.set_num_threads(1)
TOL = 1e-5

# (Sq, Sk, H, KV, causal, window, q_offset, q_block, kv_block)
CASES = {
    "causal_gqa": (48, 48, 4, 2, True, 0, 0, 16, 16),
    "window": (40, 40, 4, 2, True, 7, 0, 16, 8),
    "bidirectional": (24, 24, 2, 2, False, 0, 0, 16, 16),
    "off_blocks_g4": (37, 37, 8, 2, True, 0, 0, 16, 12),
    "q_offset": (20, 52, 4, 1, True, 0, 32, 8, 16),
    "q_offset_window": (20, 52, 4, 2, True, 10, 32, 16, 16),
}


def rel(got, want) -> float:
    g, w = got.detach().numpy(), np.asarray(want)
    return float(np.abs(g - w).max() / np.abs(w).max())


def inputs(Sq, Sk, H, KV, hd=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, Sq, H, hd).astype(np.float32),
            rng.randn(2, Sk, KV, hd).astype(np.float32),
            rng.randn(2, Sk, KV, hd).astype(np.float32),
            rng.randn(2, Sq, H, hd).astype(np.float32))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    Sq, Sk, H, KV, causal, window, off, qb, kb = CASES[request.param]
    q, k, v, w = inputs(Sq, Sk, H, KV)

    def loss(q, k, v):
        return (JA.flash_attention_remat(q, k, v, causal, window, off, qb,
                                         kb) * w).sum()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jout = jax.jit(lambda q, k, v: JA.flash_attention_remat(
        q, k, v, causal, window, off, qb, kb))(jq, jk, jv)
    jgrads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = A.flash_attention_remat(tq, tk, tv, causal, window, off, qb, kb)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                (tq, tk, tv))
    return dict(out=out, jout=jout, grads=grads, jgrads=jgrads,
                args=(q, k, v, w), opts=(causal, window, off))


def test_forward_matches_the_reference(case):
    assert rel(case["out"], case["jout"]) < TOL


@pytest.mark.parametrize("i", [0, 1, 2], ids=["dq", "dk", "dv"])
def test_gradients_match_jax_grad(case, i):
    assert case["grads"][i].shape == case["jgrads"][i].shape
    assert rel(case["grads"][i], case["jgrads"][i]) < TOL


def test_gradients_match_autograd_through_flash_attention(case):
    q, k, v, w = case["args"]
    causal, window, off = case["opts"]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = A.flash_attention(tq, tk, tv, causal=causal, window=window,
                            q_offset=off)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                (tq, tk, tv))
    assert rel(case["out"], out.detach().numpy()) < TOL
    for got, want in zip(case["grads"], grads):
        assert rel(got, want.numpy()) < TOL


def test_backward_holds_no_whole_score_matrix(monkeypatch):
    """Every recomputed probability tile is at most q_block x kv_block."""
    q, k, v, w = inputs(64, 64, 2, 2)
    seen = []
    real = torch.exp

    def exp(t, *a, **kw):
        seen.append(tuple(t.shape[-2:]))
        return real(t, *a, **kw)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = A.flash_attention_remat(tq, tk, tv, True, 0, 0, 16, 32)
    monkeypatch.setattr(torch, "exp", exp)
    torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    assert seen and max(r * c for r, c in seen) <= 16 * 32
