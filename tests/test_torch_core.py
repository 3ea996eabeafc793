"""Parity of the port's host-side core (``repro_torch.core``) with the
reference (``repro.core``): byte-identical block hashes, identical block
manager / prefix cache accounting, identical activation masks, and the
adapter-weight helpers.  The two LoRA equivalences the reference states
bitwise (rank padding, grouped vs dense delta) are held here within a
float32 tolerance, since the contraction lengths differ."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core import activation_mask as jmask
from repro.core import alora as jalora
from repro.core import block_hash as jhash
from repro.core.kv_manager import BlockManager as JBlockManager
from repro.core.prefix_cache import PrefixCache as JPrefixCache
from repro_torch.configs import get_reduced
from repro_torch.core import activation_mask as mask
from repro_torch.core import alora
from repro_torch.core import block_hash as bh
from repro_torch.core.kv_manager import BlockManager
from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.kernels.ragged_lora import ragged_grouped_lora_ref
from repro_torch.models.convert import adapters_from_jax
from repro_torch.models.layers import lora_delta

# one intra-op thread: this file shares the CPU with the rest of the suite
torch.set_num_threads(1)

# float32 tolerance for products that sum in another order or over
# another contraction length (d = 256, r <= 32 here)
RTOL, ATOL = 1e-5, 1e-6

ADAPTERS = [None, ("lora", 0), ("alora", 0), ("alora", 17), ("alora", 40),
            ("alora", 1000)]


def _keys(spec):
    if spec is None:
        return None, None
    kind, inv = spec
    return (jhash.AdapterKey("ad#v1", kind, inv),
            bh.AdapterKey("ad#v1", kind, inv))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("salt", [(), ("img", 3)])
@pytest.mark.parametrize("adapter", ADAPTERS, ids=str)
def test_block_hashes_byte_identical(seed, salt, adapter):
    toks = list(np.random.RandomState(seed).randint(0, 50000, 83))
    jk, tk = _keys(adapter)
    want = jhash.request_block_hashes(toks, 16, jk, salt)
    got = bh.request_block_hashes(toks, 16, tk, salt)
    assert got == want and len(got) == 5


def _script(rng, n_ops=300):
    """A random acquire/register/release script over hash ids."""
    return [(rng.randint(4), rng.randint(12), rng.randint(6))
            for _ in range(n_ops)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_manager_and_prefix_cache_accounting(seed):
    mgrs = (JBlockManager(24, 4), BlockManager(24, 4))
    caches = (JPrefixCache(block_size=4, kv_manager=mgrs[0]),
              PrefixCache(block_size=4, kv_manager=mgrs[1]))
    hash_fns = (jhash.request_block_hashes, bh.request_block_hashes)
    key_types = (jhash.AdapterKey, bh.AdapterKey)
    held = ([], [])
    rng = np.random.RandomState(seed)
    for op, a, b in _script(rng):
        for i, (m, c) in enumerate(zip(mgrs, caches)):
            toks = list(range(a % 3, a % 3 + 4 * b))
            # aLoRA keys activating at or past the prefix stay
            # base-aligned and hit blocks registered by base streams
            key = key_types[i]("x", "alora", 4 * b + 4 * (a % 2))
            if op == 0 and m.num_free():
                bid = m.allocate()
                chain = hash_fns[i](list(range(a % 3, a % 3 + 24)), 4)
                c.register_kv_block(chain[b], bid)
                held[i].append(bid)
            elif op == 1:
                held[i].extend(c.match_and_acquire(toks, key).kv_blocks)
            elif op == 2 and held[i]:
                m.release(held[i].pop(a % len(held[i])))
            elif op == 3:
                held[i].append(c.probe(toks, None))
                held[i].pop()
        j, t = mgrs
        assert (t.hits, t.misses, t.evictions, t.num_free()) == \
            (j.hits, j.misses, j.evictions, j.num_free())
        assert [m.ref for m in t.meta] == [m.ref for m in j.meta]
        assert t.index == j.index and held[0] == held[1]
    assert mgrs[1].hits > 0 and mgrs[1].misses > 0


@pytest.mark.parametrize("seed", range(4))
def test_activation_mask_parity(seed):
    rng = np.random.RandomState(seed)
    inv = list(rng.randint(0, 5, 2))
    toks = list(rng.randint(0, 5, 30))
    assert mask.find_invocation_start(toks, inv) == \
        jmask.find_invocation_start(toks, inv)
    pos = np.arange(30)
    for slot, kind in ((0, "alora"), (3, None), (2, "lora"), (5, "alora")):
        start = int(rng.randint(0, 30))
        np.testing.assert_array_equal(
            mask.adapter_index_for_positions(pos, slot, kind, start),
            jmask.adapter_index_for_positions(pos, slot, kind, start))


@pytest.fixture(scope="module")
def adapters():
    cfg_j = jax_reduced("granite-3.2-8b")
    cfg = get_reduced("granite-3.2-8b")
    trees = [jalora.init_adapter_weights(jax.random.key(k), cfg_j, r)
             for k, r in ((1, 8), (2, 16))]
    np_trees = [jax.tree.map(np.asarray, t) for t in trees]
    return cfg_j, cfg, trees, [adapters_from_jax(t, cfg, "cpu")
                               for t in np_trees]


def test_pad_rank_stack_and_per_layer_match_reference(adapters):
    cfg_j, cfg, jtrees, trees = adapters
    jstack = jalora.stack_adapters(cfg_j, jtrees, 32)
    stack = alora.stack_adapters(cfg, trees, 32)
    jlayers = jalora.per_layer_adapters(cfg_j, jstack)
    layers = alora.per_layer_adapters(cfg, stack)
    assert len(layers) == len(jlayers) == cfg.num_layers
    for jl, tl in zip(jlayers, layers):
        assert set(jl) == set(tl)
        for k in jl:           # zero padding and stacking copy exactly
            np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))


def test_rank_padding_holds_within_tolerance(adapters):
    """x @ [A|0] @ [B;0] == x @ A @ B within float32 rounding — not
    bitwise: the padded product contracts over 32 terms, not 8."""
    _, cfg, _, trees = adapters
    padded = alora.pad_adapter_rank(trees[0], 32)
    assert alora.adapter_rank_of(padded) == 32
    x = torch.from_numpy(np.random.RandomState(0).randn(7, cfg.d_model)
                         .astype(np.float32))
    for lw, pw in zip(alora.per_layer_adapters(cfg, trees[0]),
                      alora.per_layer_adapters(cfg, padded)):
        for a, b in (("aq", "bq"), ("ak", "bk"), ("av", "bv")):
            want = x @ lw[a] @ lw[b]
            got = x @ pw[a] @ pw[b]
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("active", [[1, 2], [2, 0], [1, 0, 0, 0]])
def test_grouped_delta_matches_dense_within_tolerance(adapters, active):
    """The grouped delta over the active slots equals the dense scan over
    every slot for tokens on active slots (within float32 rounding)."""
    _, cfg, _, trees = adapters
    layer = alora.per_layer_adapters(
        cfg, alora.stack_adapters(cfg, trees, 16))[0]
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(20, cfg.d_model).astype(np.float32))
    idx = torch.from_numpy(rng.choice([0] + [s for s in active if s],
                                      20).astype(np.int32))
    act = torch.tensor(active, dtype=torch.int32)
    got = ragged_grouped_lora_ref(x, layer["aq"], layer["bq"], idx, act)
    want = lora_delta(x, layer["aq"], layer["bq"], idx)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert not got[idx == 0].any()
