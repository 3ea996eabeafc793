"""The port's kernel modules on the CPU: their plain versions against the
reference's Pallas kernels (interpret mode) and jnp refs on the same
numpy inputs.  On CPU tensors the wrappers run the plain versions and
launch nothing.

Tolerances: float32 1e-5 (the three implementations sum in different
orders); bfloat16 2e-2 relative (rounding points differ between the
frameworks)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import ragged_lora_op, ragged_paged_attention_op
from repro.kernels.ragged_lora import ragged_grouped_lora_ref as jax_lora_ref
from repro.kernels.ref import ragged_paged_attention_ref as jax_attn_ref
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ragged_lora as rl

# one intra-op thread: this file shares the CPU with the rest of the suite
torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax and a torch array of ``dtype``."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _close(got: torch.Tensor, want, dtype: str, rows=slice(None)):
    np.testing.assert_allclose(got.float().numpy()[rows],
                               np.asarray(want, np.float32)[rows],
                               rtol=TOL[dtype], atol=TOL[dtype])


def _attention_inputs(G, seed):
    """Three requests (multi-block contexts), decode rows and prefill
    rows packed together, plus padded rows with q_lens == 0."""
    rng = np.random.RandomState(seed)
    KV, hd, bs, NB, nb = 2, 16, 4, 40, 12
    H = KV * G
    tables = rng.permutation(NB - 1)[:3 * nb].reshape(3, nb)
    tables = np.concatenate([tables, np.full((1, nb), NB - 1)])  # pad row
    rows, lens = [0, 1], [45, 9]                   # decode rows
    rows += [2] * 8
    lens += list(range(31, 39))                    # a prefill chunk
    rows += [3] * 3
    lens += [0] * 3                                # padded rows
    T = len(rows)
    return dict(
        q=rng.randn(T, H, hd).astype(np.float32),
        k=rng.randn(NB, bs, KV, hd).astype(np.float32),
        v=rng.randn(NB, bs, KV, hd).astype(np.float32),
        bt=tables.astype(np.int32), rows=np.array(rows, np.int32),
        lens=np.array(lens, np.int32), n_real=T - 3)


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_attention_matches_pallas_and_ref(G, window, dtype):
    a = _attention_inputs(G, seed=G + window)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a[n], dtype) for n in "qkv")
    meta = [a["bt"], a["rows"], a["lens"]]
    got = pa.ragged_paged_attention(tq, tk, tv,
                                    *map(torch.from_numpy, meta),
                                    window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    rows = slice(0, a["n_real"])            # q_lens == 0 rows excluded
    want_kernel = ragged_paged_attention_op(jq, jk, jv, *map(jnp.asarray,
                                                             meta),
                                            window=window, interpret=True)
    want_ref = jax_attn_ref(jq, jk, jv, *map(jnp.asarray, meta),
                            window=window)
    _close(got, want_kernel, dtype, rows)
    _close(got, want_ref, dtype, rows)


def _lora_inputs(T, out, active, seed, n_slots=4, r=8, d=32):
    rng = np.random.RandomState(seed)
    a = rng.randn(n_slots, d, r).astype(np.float32)
    b = rng.randn(n_slots, r, out).astype(np.float32)
    a[0] = b[0] = 0.0                               # slot 0: zero adapter
    # tokens on slot 0, on active slots and on a resident inactive slot
    choices = [0, n_slots - 1] + [s for s in active if s]
    idx = rng.choice(choices, T).astype(np.int32)
    return dict(x=rng.randn(T, d).astype(np.float32), a=a, b=b, idx=idx,
                act=np.array(active, np.int32))


@pytest.mark.parametrize("T,out", [(5, 40), (16, 300), (33, 256)])
@pytest.mark.parametrize("active", [[1, 2], [2, 0], [1, 0, 0, 0]])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_lora_matches_pallas_and_ref(T, out, active, dtype):
    """out not a multiple of the TPU tile, K padded with slot 0, slot 0 a
    no-op, and tokens on the resident-but-inactive slot 3 that must not
    leak into the delta."""
    i = _lora_inputs(T, out, active, seed=T + out)
    (jx, tx), (ja, ta), (jb, tb) = (_pair(i[n], dtype) for n in "xab")
    ti, tact = torch.from_numpy(i["idx"]), torch.from_numpy(i["act"])
    got = rl.ragged_grouped_lora(tx, ta, tb, ti, tact)
    assert got.dtype == tx.dtype and got.shape == (T, out)
    want_kernel = ragged_lora_op(jx, ja, jb, jnp.asarray(i["idx"]),
                                 jnp.asarray(i["act"]), interpret=True)
    want_ref = jax_lora_ref(jx, ja, jb, jnp.asarray(i["idx"]),
                            jnp.asarray(i["act"]))
    _close(got, want_kernel, dtype)
    _close(got, want_ref, dtype)
    dead = ~np.isin(i["idx"], [s for s in active if s])
    assert dead.any() and not got[torch.from_numpy(dead)].any()


def test_wrappers_launch_nothing_on_cpu_tensors():
    pa.ragged_paged_attention.launches = 0
    rl.ragged_grouped_lora.launches = 0
    a = _attention_inputs(4, seed=0)
    pa.ragged_paged_attention(*(torch.from_numpy(a[n]) for n in
                                ("q", "k", "v", "bt", "rows", "lens")))
    i = _lora_inputs(8, 24, [1, 2], seed=0)
    rl.ragged_grouped_lora(*(torch.from_numpy(i[n]) for n in
                             ("x", "a", "b", "idx", "act")))
    assert pa.ragged_paged_attention.launches == 0
    assert rl.ragged_grouped_lora.launches == 0


def test_wrappers_reject_other_devices():
    x = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="device"):
        rl.ragged_grouped_lora(x, x, x, x, x)
