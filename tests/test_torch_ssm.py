"""The port's SSM slice on the CPU against the reference, on the same
seeded numpy inputs and converted weights:

* ``ragged_ssd_scan_ref`` against the reference's jnp oracle (float32,
  1e-5 relative) and against the Pallas kernel in interpret mode (1e-4),
  over ragged batches with decode singletons and segments that cross a
  64-token chunk;
* ``ssd_ragged_forward`` (reduced mamba2, with the adapter delta) against
  the reference's: y, the new live SSM and conv rows, and the snapshot
  SSM and conv rows;
* two mixed runner steps of reduced mamba2 and zamba2 against the
  reference runner: identical sampled ids, the live pools, the K/V pools
  and the boundary states allclose (1e-4; two layers of float32).

On CPU tensors the scan wrapper runs the plain version and launches
nothing.  Every comparison excludes the dump slot and dump block, which
padded rows write with duplicate indices."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core.alora import init_adapter_weights as jax_adapter
from repro.core.alora import per_layer_adapters as jax_per_layer
from repro.core.alora import stack_adapters as jax_stack
from repro.kernels.ops import ragged_ssd_scan_op
from repro.kernels.ref import ragged_ssd_scan_ref as jax_scan_ref
from repro.models import init_params as jax_init
from repro.models import ssm as jax_ssm
from repro.serving import runner as JR
from repro_torch.configs import get_reduced
from repro_torch.core.alora import per_layer_adapters, stack_adapters
from repro_torch.kernels import ssd_chunk
from repro_torch.models import ssm
from repro_torch.models.convert import adapters_from_jax, params_from_jax
from repro_torch.serving import runner as R

# one intra-op thread: this file shares the CPU with the rest of the suite
torch.set_num_threads(1)


def _scan_inputs(lens, H, P, N, S, seed):
    """A packed batch of segments of ``lens``; a segment of length 1 is a
    decode singleton.  Every segment starts from its own slot's state."""
    rng = np.random.RandomState(seed)
    T = sum(lens)
    x = rng.randn(T, H, P).astype(np.float32)
    B = (rng.randn(T, H, N) * 0.5).astype(np.float32)
    C = (rng.randn(T, H, N) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(T, H))).astype(np.float32)
    dA = (-np.exp(rng.randn(T, H) * 0.3) * dt).astype(np.float32)
    init = rng.randn(S, H, N, P).astype(np.float32)
    seg_ids = np.concatenate([[i] * n for i, n in enumerate(lens)])
    starts = np.zeros(T, bool)
    slots = np.zeros(T, np.int32)
    off = 0
    for i, n in enumerate(lens):
        starts[off] = True
        slots[off:off + n] = (i * 3) % S
        off += n
    return dict(x=x, B=B, C=C, dA=dA, dt=dt, init=init, starts=starts,
                slots=slots, seg_ids=seg_ids.astype(np.int32))


LENS = [[1, 1, 1, 1],                  # decode-only
        [1, 1, 70, 23],                # a segment crossing a 64-token chunk
        [1, 40, 1, 50, 1]]             # singletons between long segments


@pytest.mark.parametrize("lens", LENS)
def test_scan_ref_matches_reference_oracle_and_pallas(lens):
    a = _scan_inputs(lens, H=3, P=16, N=8, S=5, seed=sum(lens))
    ty, ts = ssd_chunk.ragged_ssd_chunk_scan(
        *(torch.from_numpy(a[k]) for k in ("x", "B", "C", "dA", "dt")),
        torch.from_numpy(a["starts"].astype(np.int32)),
        torch.from_numpy(a["slots"]), torch.from_numpy(a["init"]))
    jargs = [jnp.asarray(a[k]) for k in ("x", "B", "C", "dA", "dt")]
    jy, js = jax_scan_ref(*jargs, jnp.asarray(a["starts"]),
                          jnp.asarray(a["slots"]), jnp.asarray(a["init"]))
    for got, want in ((ty, jy), (ts, js)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    py, ps = ragged_ssd_scan_op(*jargs, jnp.asarray(a["seg_ids"]),
                                jnp.asarray(a["starts"]),
                                jnp.asarray(a["slots"]),
                                jnp.asarray(a["init"]), interpret=True)
    for got, want in ((ty, py), (ts, ps)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    assert ssd_chunk.ragged_ssd_chunk_scan.launches == 0


def test_scan_wrapper_rejects_other_devices():
    t = torch.zeros((1, 1, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_chunk.ragged_ssd_chunk_scan(t, t, t, t, t, t, t, t)


# ---------------------------------------------------------------------------
# one SSM sublayer, with the adapter delta
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mamba():
    cfg_j = jax_reduced("mamba2-2.7b")
    cfg = get_reduced("mamba2-2.7b")
    pj = jax_init(jax.random.key(0), cfg_j)
    aj = jax_adapter(jax.random.key(3), cfg_j, 8)
    stack_j = jax_per_layer(cfg_j, jax_stack(cfg_j, [aj], 8))
    stack = per_layer_adapters(cfg, stack_adapters(cfg, [adapters_from_jax(
        jax.tree.map(np.asarray, aj), cfg, "cpu")], 8))
    params = params_from_jax(jax.tree.map(np.asarray, pj), cfg, "cpu")
    return cfg_j, cfg, pj, params, stack_j, stack


def test_ssd_ragged_forward_matches_reference(mamba):
    cfg_j, cfg, pj, params, stack_j, stack = mamba
    rng = np.random.RandomState(0)
    _, nh, ch = ssm.ssm_dims(cfg)
    s = cfg.ssm
    MR, d = 5, cfg.d_model
    # rows: a decode singleton (slot 0), a 21-token chunk continuing slot
    # 2 with an adapter from position 5 on, a 2-token first chunk (slot
    # 1), then 4 padded rows on the dump slot
    lens, slots = [1, 21, 2], [0, 2, 1]
    T, Tb, Rb = sum(lens), 32, 4
    dump = MR - 1
    tok_slots = np.full(Tb, dump, np.int32)
    row_cols = np.zeros(Tb, np.int32)
    adapter_idx = np.zeros(Tb, np.int32)
    last_rows = np.zeros(Rb, np.int32)
    row_slots = np.full(Rb, dump, np.int32)
    off = 0
    for i, (n, sl) in enumerate(zip(lens, slots)):
        tok_slots[off:off + n] = sl
        row_cols[off:off + n] = np.arange(n)
        last_rows[i] = off + n - 1
        row_slots[i] = sl
        off += n
    adapter_idx[1 + 5:1 + 21] = 1
    snap_rows = np.array([1 + 15, 1 + 7, 0, 0], np.int32)   # padded to 4
    x = (rng.randn(Tb, d) * 0.5).astype(np.float32)
    live_ssm = rng.randn(MR, nh, s.state_dim, s.head_dim).astype(np.float32)
    live_conv = rng.randn(MR, s.conv_width - 1, ch).astype(np.float32)
    act = np.array([1], np.int32)
    lp_j = jax.tree.map(lambda a: a[0, 0], pj["blocks"]["seg0"])["ssm"]
    ref = jax.jit(functools.partial(jax_ssm.ssd_ragged_forward, cfg=cfg_j,
                                    impl="ref", lora_impl="ref"))
    want = ref(
        lp_j, x=jnp.asarray(x), live_ssm=jnp.asarray(live_ssm),
        live_conv=jnp.asarray(live_conv), tok_slots=jnp.asarray(tok_slots),
        row_cols=jnp.asarray(row_cols),
        seg_ids=jnp.asarray(np.zeros(Tb, np.int32)),
        snap_rows=jnp.asarray(snap_rows), last_rows=jnp.asarray(last_rows),
        row_slots=jnp.asarray(row_slots), alora=stack_j[0],
        adapter_idx=jnp.asarray(adapter_idx), active_slots=jnp.asarray(act))
    t_ssm = torch.from_numpy(live_ssm.copy())
    t_conv = torch.from_numpy(live_conv.copy())
    t = torch.from_numpy
    snap_ssm = torch.empty((len(snap_rows),) + live_ssm.shape[1:])
    snap_conv = torch.empty((len(snap_rows),) + live_conv.shape[1:])
    y = ssm.ssd_ragged_forward(
        params["layers"][0]["ssm"], cfg, t(x), live_ssm=t_ssm,
        live_conv=t_conv, tok_slots=t(tok_slots), row_cols=t(row_cols),
        snap_rows=t(snap_rows), last_rows=t(last_rows),
        row_slots=t(row_slots), snap_ssm_out=snap_ssm,
        snap_conv_out=snap_conv, alora=stack[0], adapter_idx=t(adapter_idx),
        active_slots=t(act))
    np.testing.assert_allclose(y.numpy()[:T], np.asarray(want[0])[:T],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_ssm.numpy()[:dump],
                               np.asarray(want[1])[:dump], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(t_conv.numpy()[:dump],
                               np.asarray(want[2])[:dump], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(snap_ssm.numpy()[:2],
                               np.asarray(want[3])[:2], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(snap_conv.numpy()[:2],
                               np.asarray(want[4])[:2], rtol=1e-6, atol=1e-6)
    # the untouched run slot (3) keeps its state
    np.testing.assert_array_equal(t_ssm.numpy()[3], live_ssm[3])


# ---------------------------------------------------------------------------
# two mixed runner steps
# ---------------------------------------------------------------------------
NB, BS, MR, NS = 32, 16, 5, 9
# request A: base model, prefill 0..19 in blocks [3, 7] on run slot 0;
# request B: an aLoRA request on adapter slot 1 activating at position 6,
# prefill 0..11 then 12..31 in blocks [10, 11] on run slot 2
REQS = [dict(spans=[(0, 20), (20, 21)], blocks=[3, 7], inv=None, run=0),
        dict(spans=[(0, 12), (12, 32)], blocks=[10, 11], inv=6, run=2)]


def _batch(cfg, emb, step):
    """Step 0: both prompts' first chunks.  Step 1: A's first decode row
    (token read from the device buffer) and B's second chunk."""
    rng = np.random.RandomState(step)
    cols = {k: [] for k in ("tok", "emb", "use", "pos", "ad", "rows", "cols",
                            "wb", "wo", "fb")}
    out_rows, tables, snaps = [], [], []
    for i, q in enumerate(REQS):
        lo, hi = q["spans"][step]
        decode = i == 0 and step == 1
        pos = np.arange(lo, hi)
        n = len(pos)
        toks = rng.randint(10, cfg.vocab_size, n)
        t0 = len(cols["pos"])
        cols["tok"] += [0] * n if decode else list(toks)
        cols["emb"].append(np.zeros((n, cfg.d_model), np.float32) if decode
                           else emb[toks])
        cols["use"] += [not decode] * n
        cols["fb"] += [decode] * n
        cols["pos"] += list(pos)
        cols["ad"] += [1 if q["inv"] is not None and p >= q["inv"] else 0
                       for p in pos]
        cols["rows"] += [i] * n
        cols["cols"] += list(range(n))
        cols["wb"] += [q["blocks"][p // BS] for p in pos]
        cols["wo"] += [p % BS for p in pos]
        out_rows.append(len(cols["pos"]) - 1)
        tables.append(q["blocks"])
        if not decode:
            snaps += [t0 + (b + 1) * BS - 1 - lo
                      for b in range(lo // BS, hi // BS)]
    i32 = lambda k: np.array(cols[k], np.int32)  # noqa: E731
    kw = dict(tok_ids=i32("tok"), embeds=np.concatenate(cols["emb"]),
              use_embeds=np.array(cols["use"]), positions=i32("pos"),
              adapter_idx=i32("ad"), req_rows=i32("rows"),
              row_cols=i32("cols"), write_bids=i32("wb"),
              write_offs=i32("wo"), block_tables=tables,
              out_rows=np.array(out_rows, np.int32),
              run_slots=np.array([q["run"] for q in REQS], np.int32),
              snap_rows=np.array(snaps, np.int32),
              active_slots=np.array([1], np.int32),
              from_buf=np.array(cols["fb"]))
    return JR.MixedBatch(**kw), R.MixedBatch(**kw), len(snaps)


@pytest.fixture(scope="module", params=["mamba2-2.7b", "zamba2-2.7b"])
def runners(request):
    cfg_j = jax_reduced(request.param)
    cfg = get_reduced(request.param)
    pj = jax_init(jax.random.key(0), cfg_j)
    aj = jax_adapter(jax.random.key(3), cfg_j, 8)
    rc = dict(block_size=BS, num_blocks=NB, max_running=MR,
              num_state_slots=NS)
    jr = JR.ModelRunner(cfg_j, pj, JR.RunnerConfig(**rc),
                        jax_per_layer(cfg_j, jax_stack(cfg_j, [aj], 8)))
    stack = stack_adapters(cfg, [adapters_from_jax(
        jax.tree.map(np.asarray, aj), cfg, "cpu")], 8)
    tr = R.ModelRunner(cfg, params_from_jax(jax.tree.map(np.asarray, pj),
                                            cfg, "cpu"),
                       R.RunnerConfig(**rc), per_layer_adapters(cfg, stack),
                       device="cpu")
    return cfg, jr, tr, np.asarray(pj["embed"]["tok"])


def _close(got: torch.Tensor, want, sl=slice(None)):
    np.testing.assert_allclose(got.numpy()[sl], np.asarray(want)[sl],
                               rtol=1e-4, atol=1e-4)


def test_two_mixed_steps_match_reference(runners):
    cfg, jr, tr, emb = runners
    assert (tr.La, tr.Ls) == (jr.La, jr.Ls)
    assert (tr.k_pool is None) == (jr.La == 0)
    for step in (0, 1):
        jmb, tmb, n_snap = _batch(cfg, emb, step)
        want, (jb_ssm, jb_conv) = jr.execute_batch(jmb)
        handle = tr.submit_batch(tmb)
        got = tr.fetch_sampled(handle)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tr.tok_buf.numpy()[:MR - 1],
                                      np.asarray(jr.tok_buf)[:MR - 1])
        _close(tr.live_ssm, jr.live_ssm, (slice(None), slice(0, MR - 1)))
        _close(tr.live_conv, jr.live_conv, (slice(None), slice(0, MR - 1)))
        b_ssm, b_conv = handle.boundary
        assert b_ssm.shape == jb_ssm.shape and n_snap > 0
        _close(b_ssm, jb_ssm, (slice(None), slice(0, n_snap)))
        _close(b_conv, jb_conv, (slice(None), slice(0, n_snap)))
        if tr.La:
            for tp, jp in ((tr.k_pool, jr.k_pool), (tr.v_pool, jr.v_pool)):
                _close(tp, jp, (slice(None), slice(0, NB - 1)))
    # snapshot, restore and reset: the same copies on both pools
    for r, boundary in ((tr, handle.boundary), (jr, (jb_ssm, jb_conv))):
        r.snapshot_boundary(boundary, 1, 3)
        r.snapshot_live(2, 4)
        r.restore_state(3, 1)
        r.reset_live(0)
    for tp, jp in ((tr.snap_ssm, jr.snap_ssm), (tr.snap_conv, jr.snap_conv),
                   (tr.live_ssm, jr.live_ssm),
                   (tr.live_conv, jr.live_conv)):
        _close(tp, jp, (slice(None), slice(0, tp.shape[1] - 1)))
    assert float(tr.live_ssm[:, 0].abs().max()) == 0.0
    assert tr.call_counts["mixed_step"] == 2
