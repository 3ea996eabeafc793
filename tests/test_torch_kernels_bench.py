"""The kernel-bench slice of the port on the CPU: decode paged attention,
the fused aLoRA QKV projection and the dense SSD chunk scan.  Their plain
versions (which the wrappers run on CPU tensors) against the reference's
Pallas kernels in interpret mode and its jnp refs, on the same numpy
inputs, at the shapes of the reference's own kernel tests; and the bench
entry point at its reduced shapes.

Tolerances, as the reference's kernel tests state them: attention
float32 2e-5 and bfloat16 3e-2; the projection float32 1e-5 and bfloat16
2e-2; the scan 2e-4 (the implementations sum in different orders, and
bfloat16 rounds at other points in the two frameworks)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import (alora_qkv_op, paged_attention_op,
                               ssd_chunk_scan_op)
from repro.kernels.ref import alora_qkv_ref as jax_alora_ref
from repro.kernels.ref import paged_attention_ref as jax_attn_ref
from repro.kernels.ref import ssd_chunk_ref as jax_ssd_ref
from repro_torch.kernels import alora_qkv as aq
from repro_torch.kernels import bench
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssd_chunk as sc

# one intra-op thread: this file shares the CPU with the rest of the suite
torch.set_num_threads(1)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax and a torch array of ``dtype``."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# B4: decode paged attention
# ---------------------------------------------------------------------------
def _attention_inputs(B, H, KV, hd, NB, bs, nb, seed):
    rng = np.random.RandomState(seed)
    return dict(q=rng.randn(B, H, hd).astype(np.float32),
                k=rng.randn(NB, bs, KV, hd).astype(np.float32),
                v=rng.randn(NB, bs, KV, hd).astype(np.float32),
                bt=rng.randint(0, NB, (B, nb)).astype(np.int32),
                lens=rng.randint(1, nb * bs + 1, B).astype(np.int32))


@pytest.mark.parametrize("B,H,KV,hd,NB,bs,nb,window", [
    (3, 8, 2, 32, 16, 8, 4, 0),
    (2, 4, 4, 16, 8, 4, 2, 8),       # MHA + window
    (1, 16, 2, 64, 32, 16, 8, 0),    # GQA 8:1
    (4, 4, 1, 8, 8, 4, 4, 0),        # single kv head
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_matches_pallas_and_ref(B, H, KV, hd, NB, bs, nb,
                                                window, dtype):
    a = _attention_inputs(B, H, KV, hd, NB, bs, nb, seed=B * nb + window)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a[n], dtype) for n in "qkv")
    bt, lens = torch.from_numpy(a["bt"]), torch.from_numpy(a["lens"])
    got = pa.paged_attention(tq, tk, tv, bt, lens, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert torch.equal(got, pa.paged_attention_ref(tq, tk, tv, bt, lens,
                                                   window=window))
    meta = (jnp.asarray(a["bt"]), jnp.asarray(a["lens"]))
    tol = 2e-5 if dtype == "float32" else 3e-2
    _close(got, paged_attention_op(jq, jk, jv, *meta, window=window,
                                   interpret=True), tol)
    _close(got, jax_attn_ref(jq, jk, jv, *meta, window=window), tol)


@pytest.mark.parametrize("window", [0, 6])
def test_paged_attention_padding_ids_change_nothing(window):
    """Table entries past a sequence's length may be any block id."""
    a = _attention_inputs(4, 8, 2, 16, 24, 4, 6, seed=5 + window)
    lens = np.array([1, 7, 13, 24], np.int32)
    rng = np.random.RandomState(window)
    used = -(-lens // 4)
    other = a["bt"].copy()
    for b, n in enumerate(used):
        other[b, n:] = rng.randint(0, 24, 6 - n)
        a["bt"][b, n:] = 0
    q, k, v = (torch.from_numpy(a[n]) for n in "qkv")
    tl = torch.from_numpy(lens)
    got = pa.paged_attention(q, k, v, torch.from_numpy(a["bt"]), tl,
                             window=window)
    assert (other != a["bt"]).any()
    assert torch.equal(got, pa.paged_attention(q, k, v,
                                                torch.from_numpy(other), tl,
                                                window=window))


# ---------------------------------------------------------------------------
# B6: fused aLoRA QKV projection
# ---------------------------------------------------------------------------
def _alora_inputs(T, d, out, n, r, seed):
    rng = np.random.RandomState(seed)
    a = (rng.randn(n, d, r) * 0.1).astype(np.float32)
    a[0] = 0.0
    return dict(x=rng.randn(T, d).astype(np.float32),
                w=(rng.randn(d, out) * 0.1).astype(np.float32), a=a,
                b=(rng.randn(n, r, out) * 0.1).astype(np.float32),
                idx=rng.randint(0, n, T).astype(np.int32))


@pytest.mark.parametrize("T,d,out,n,r", [
    (64, 32, 48, 2, 4),
    (100, 64, 96, 3, 8),        # T not a multiple of the TPU tile
    (7, 32, 48, 4, 16),         # tiny T
    (256, 128, 256, 1, 4),      # zero-adapter-only stack
    (33, 48, 64, 5, 32),
    (130, 264, 200, 5, 8),      # T, d and out off the CUDA kernel's tiles
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_alora_qkv_matches_pallas_and_ref(T, d, out, n, r, dtype):
    i = _alora_inputs(T, d, out, n, r, seed=T + d + n)
    (jx, tx), (jw, tw), (ja, ta), (jb, tb) = (_pair(i[k], dtype)
                                              for k in "xwab")
    ti = torch.from_numpy(i["idx"])
    got = aq.alora_qkv(tx, tw, ta, tb, ti)
    assert got.dtype == tx.dtype and got.shape == (T, out)
    tol = 1e-5 if dtype == "float32" else 2e-2
    ji = jnp.asarray(i["idx"])
    _close(got, alora_qkv_op(jx, jw, ja, jb, ji, interpret=True), tol)
    _close(got, jax_alora_ref(jx, jw, ja, jb, ji), tol)


def test_alora_qkv_mask_semantics():
    """Index 0 (even with a nonzero A[0]) and indices outside [1, n) get
    no delta: their rows equal x @ W exactly; the others differ."""
    i = _alora_inputs(40, 16, 24, 3, 4, seed=1)
    rng = np.random.RandomState(2)
    i["a"][0] = rng.randn(16, 4)
    i["idx"] = np.array([0, 1, 2, 3, -1] * 8, np.int32)
    x, w, a, b, idx = (torch.from_numpy(i[k]) for k in
                       ("x", "w", "a", "b", "idx"))
    got = aq.alora_qkv(x, w, a, b, idx)
    plain = (idx == 0) | (idx == 3) | (idx == -1)
    assert torch.equal(got[plain], (x @ w)[plain])
    assert (got[~plain] - (x @ w)[~plain]).abs().min() > 0


# ---------------------------------------------------------------------------
# B5: dense SSD chunk scan
# ---------------------------------------------------------------------------
def _ssd_inputs(Bt, S, H, P, N, seed):
    rng = np.random.RandomState(seed)
    dt = np.log1p(np.exp(rng.randn(Bt, S, H))).astype(np.float32)
    return (rng.randn(Bt, S, H, P).astype(np.float32),
            (rng.randn(Bt, S, H, N) * 0.5).astype(np.float32),
            (rng.randn(Bt, S, H, N) * 0.5).astype(np.float32),
            (-np.exp(rng.randn(Bt, S, H) * 0.3) * dt).astype(np.float32),
            dt)


@pytest.mark.parametrize("Bt,S,H,P,N,chunk", [
    (2, 64, 3, 16, 8, 16),
    (1, 128, 2, 32, 16, 32),
    (2, 17, 1, 8, 4, 8),        # S not a multiple of the chunk
    (1, 96, 4, 64, 32, 48),     # bigger state
    (1, 130, 2, 40, 32, 64),    # S and P off the CUDA kernel's tiles
])
def test_ssd_chunk_scan_matches_pallas_and_ref(Bt, S, H, P, N, chunk):
    arrs = _ssd_inputs(Bt, S, H, P, N, seed=S)
    y, st = sc.ssd_chunk_scan(*map(torch.from_numpy, arrs))
    assert y.shape == (Bt, S, H, P) and st.shape == (Bt, H, N, P)
    assert y.dtype == st.dtype == torch.float32
    jargs = tuple(map(jnp.asarray, arrs))
    for want_y, want_st in (ssd_chunk_scan_op(*jargs, chunk=chunk,
                                              interpret=True),
                            jax_ssd_ref(*jargs)):
        _close(y, want_y, 2e-4)
        _close(st, want_st, 2e-4)


# ---------------------------------------------------------------------------
# the wrappers and the bench entry point
# ---------------------------------------------------------------------------
def _small_calls():
    a = _attention_inputs(2, 4, 2, 8, 8, 4, 2, seed=0)
    i = _alora_inputs(8, 16, 24, 3, 4, seed=0)
    s = _ssd_inputs(1, 9, 2, 8, 4, seed=0)
    return [
        (pa.paged_attention, [torch.from_numpy(a[n]) for n in
                              ("q", "k", "v", "bt", "lens")]),
        (aq.alora_qkv, [torch.from_numpy(i[n]) for n in
                        ("x", "w", "a", "b", "idx")]),
        (sc.ssd_chunk_scan, list(map(torch.from_numpy, s))),
    ]


def test_wrappers_launch_nothing_on_cpu_tensors():
    for fn, args in _small_calls():
        fn.launches = 0
        fn(*args)
        assert fn.launches == 0


@pytest.mark.parametrize("which", [0, 1, 2])
def test_wrappers_reject_other_devices(which):
    fn, args = _small_calls()[which]
    with pytest.raises(ValueError, match="device"):
        fn(*(t.to("meta") for t in args))


def test_bench_reduced_cpu_prints_one_plain_row_per_kernel(capsys):
    res = bench.run(device="cpu", reduced=True)
    rows = [line.split(",") for line in
            capsys.readouterr().out.strip().splitlines()]
    assert sorted(r[0].split("/")[1] for r in rows) == sorted(bench.WRAPPERS)
    assert all(r[0].endswith("/plain-cpu") and float(r[1]) > 0
               for r in rows)
    assert len(res) == 3
    assert all("ms" not in v and v["bound_ms"] > 0 for v in res.values())


def test_bench_default_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.run()


def test_bench_edge_alora_case_reaches_the_skipped_indices():
    """The edge case the smoke holds on the card: slot 0 holds a nonzero
    adapter and some tokens carry -1 or n; all three rows equal x @ W."""
    gen = torch.Generator().manual_seed(0)
    case = bench.alora_case(gen, "cpu", torch.float32, T=100, d=64, out=96,
                            n=4, r=8, name="edge", edge=True)
    x, w, a, b, idx = case.args
    assert b[0].abs().max() > 0 and a[0].abs().max() > 0
    for i in (-1, 0, 4):
        assert (idx == i).any()
    skip = (idx < 1) | (idx >= 4)
    got = aq.alora_qkv(*case.args)
    assert torch.equal(got[skip], (x @ w)[skip])


@pytest.mark.parametrize("S,N,P", [(1, 32, 16), (70, 32, 16), (2048, 128, 64)])
def test_ssd_bound_counts_the_best_chunk_length(S, N, P):
    """The scan's operation count is the chunked form's at its best chunk
    length, each chunk counted one by one here; at N 128, P 64 that is
    near 35 K operations per token, below the recurrence's 5 N P."""
    def chunked(Q):
        ops, t = 0, 0
        while t < S:
            q = min(Q, S - t)
            ops += q * (q + 1) * (N + P) + 2 * q * N * P
            if t:                         # C . state and the decay
                ops += 2 * q * N * P + N * P
            t += q
        return ops
    best = min(chunked(Q) for Q in range(1, min(S, 40) + 1))
    assert bench.ssd_ops(S, N, P) == best
    if S == 1:
        assert best == 2 * N * P + 2 * (N + P)
    assert best < 5 * N * P * S + 2 * (N + P) * S
