"""One hand-built mixed batch through the reference runner
(``repro.serving.runner.ModelRunner.execute_batch``) and through the
port's, on converted weights (reduced granite, float32): the sampled ids
agree, the K/V pools and the token buffer agree, and a second step whose
decode rows read their tokens from the device buffer (``from_buf``)
agrees too.  Pools are compared at 1e-4 (40-token contexts, two
layers); the dump block, which padded rows write with duplicate
indices, is excluded."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core.alora import init_adapter_weights as jax_adapter
from repro.core.alora import per_layer_adapters as jax_per_layer
from repro.core.alora import stack_adapters as jax_stack
from repro.models import init_params as jax_init
from repro.serving import runner as JR
from repro_torch.configs import get_reduced
from repro_torch.core.alora import per_layer_adapters, stack_adapters
from repro_torch.models.convert import adapters_from_jax, params_from_jax
from repro_torch.serving import runner as R

# one intra-op thread: this file shares the CPU with the rest of the suite
torch.set_num_threads(1)

NB, BS, MR = 32, 16, 5
# request A: base model, prefill 0..19 in blocks [3, 7]; request B: an
# aLoRA request on slot 1 activating at position 6, prefill 0..11 in [10]
REQS = [dict(lo=0, hi=20, blocks=[3, 7], slot=0, inv=None, run=0),
        dict(lo=0, hi=12, blocks=[10], slot=1, inv=6, run=2)]


@pytest.fixture(scope="module")
def runners():
    cfg_j = jax_reduced("granite-3.2-8b")
    cfg = get_reduced("granite-3.2-8b")
    pj = jax_init(jax.random.key(0), cfg_j)
    aj = jax_adapter(jax.random.key(3), cfg_j, 8)
    jr = JR.ModelRunner(cfg_j, pj, JR.RunnerConfig(
        block_size=BS, num_blocks=NB, max_running=MR),
        jax_per_layer(cfg_j, jax_stack(cfg_j, [aj], 8)))
    stack = stack_adapters(cfg, [adapters_from_jax(
        jax.tree.map(np.asarray, aj), cfg, "cpu")], 8)
    tr = R.ModelRunner(cfg, params_from_jax(jax.tree.map(np.asarray, pj),
                                            cfg, "cpu"),
                       R.RunnerConfig(block_size=BS, num_blocks=NB,
                                      max_running=MR),
                       per_layer_adapters(cfg, stack), device="cpu")
    emb = np.asarray(pj["embed"]["tok"])
    return cfg, jr, tr, emb


def _aidx(req, positions):
    if req["inv"] is None:
        return np.zeros(len(positions), np.int32)
    return np.where(positions >= req["inv"], req["slot"], 0).astype(np.int32)


def _batch(cfg, emb, step):
    """Step 0: both prompts as prefill chunks.  Step 1: one decode row
    each, tokens read from the device buffer."""
    cols = {k: [] for k in ("tok", "emb", "use", "pos", "ad", "rows", "wb",
                            "wo", "fb")}
    out_rows, tables = [], []
    rng = np.random.RandomState(0)
    for i, q in enumerate(REQS):
        pos = np.arange(q["lo"], q["hi"]) if step == 0 \
            else np.array([q["hi"]])
        n = len(pos)
        toks = rng.randint(10, cfg.vocab_size, n)
        cols["tok"] += [0] * n if step else list(toks)
        cols["emb"].append(emb[toks] if step == 0
                           else np.zeros((n, cfg.d_model), np.float32))
        cols["use"] += [step == 0] * n
        cols["fb"] += [step == 1] * n
        cols["pos"] += list(pos)
        cols["ad"] += list(_aidx(q, pos))
        cols["rows"] += [i] * n
        cols["wb"] += [q["blocks"][p // BS] for p in pos]
        cols["wo"] += [p % BS for p in pos]
        out_rows.append(len(cols["pos"]) - 1)
        tables.append(q["blocks"])
    i32 = lambda k: np.array(cols[k], np.int32)  # noqa: E731
    common = dict(tok_ids=i32("tok"), embeds=np.concatenate(cols["emb"]),
                  use_embeds=np.array(cols["use"]), positions=i32("pos"),
                  adapter_idx=i32("ad"), req_rows=i32("rows"),
                  write_bids=i32("wb"), write_offs=i32("wo"),
                  block_tables=tables, out_rows=np.array(out_rows, np.int32),
                  run_slots=np.array([q["run"] for q in REQS], np.int32),
                  active_slots=np.array([1], np.int32),
                  from_buf=np.array(cols["fb"]))
    T = len(cols["pos"])
    jmb = JR.MixedBatch(row_cols=np.zeros(T, np.int32),
                        snap_rows=np.zeros(0, np.int32), **common)
    return jmb, R.MixedBatch(**common)


def test_two_mixed_steps_match_reference(runners):
    cfg, jr, tr, emb = runners
    for step in (0, 1):
        jmb, tmb = _batch(cfg, emb, step)
        want, _ = jr.execute_batch(jmb)
        got = tr.execute_batch(tmb)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tr.tok_buf.numpy()[:MR - 1],
                                      np.asarray(jr.tok_buf)[:MR - 1])
        for tp, jp in ((tr.k_pool, jr.k_pool), (tr.v_pool, jr.v_pool)):
            np.testing.assert_allclose(tp.numpy()[:, :NB - 1],
                                       np.asarray(jp)[:, :NB - 1],
                                       rtol=1e-4, atol=1e-4)
    assert tr.call_counts["mixed_step"] == 2
    assert [t for _, _, t in tr.d2h_fetches] == ["step", "step"]
    # the second step's decode rows wrote their K/V where scheduled
    assert np.abs(tr.k_pool.numpy()[:, 7, 20 % BS]).sum() > 0


def test_host_buffer_pool_double_buffers():
    pool = R.HostBufferPool()
    a = pool.take("x", 3, np.int32, fill=7)
    pool.flip()
    b = pool.take("x", 3, np.int32)
    assert not np.shares_memory(a, b) and (a == 7).all() and (b == 0).all()
    pool.flip()
    c = pool.take("x", 5, np.int32, fill=1)     # grows past capacity 4
    assert c.shape == (5,) and (c == 1).all()


def test_next_pow2_and_d2h_log_trim():
    assert [R.next_pow2(n) for n in (0, 1, 3, 8, 9)] == [1, 1, 4, 8, 16]
    log = []
    for i in range(R.D2H_LOG_MAX + 5):
        R.log_d2h(log, i, "int32", "step")
    assert len(log) <= R.D2H_LOG_MAX and log[-1][0] == R.D2H_LOG_MAX + 4
