"""The launch plan of the port's paged-attention kernels, on the CPU.

``repro_torch.kernels.paged_attention.plan`` gives the CUDA launch from
the shapes alone: the grid (packed rows, KV heads, context splits), the
query-tile size and the split scratch.  These tests hold it to what the
kernel needs: a grid that no length changes (a step can be replayed from
a CUDA graph per shape bucket), splits that cover the table's span
exactly, a plan for every attention config of the reference's
registry (ported or not) with query tiles of ``64 // G`` rows, the constants
the CUDA source holds, and a ``ValueError`` for a head size, a G or a
block size the kernel does not take.  Each block's shared memory is
sized in the CUDA source, which asserts at compile time that it fits
the card for every head size it is built for."""
import inspect
import re
from pathlib import Path

import pytest
import torch

from repro.configs import all_configs as ref_configs
from repro.configs import get_config as ref_config
from repro.configs import get_reduced as ref_reduced
from repro_torch.configs import ATTN
from repro_torch.kernels import paged_attention as pa

SOURCE = Path(pa.__file__).resolve().parents[1] / "csrc" / \
    "paged_attention.cu"
# every configuration of the reference's registry that has attention
# layers, full and reduced, ported or not (read from ``repro.configs``:
# the port may not import it, a test may)
ATTN_CONFIGS = [(arch, reduced) for arch in sorted(ref_configs())
                for reduced in (False, True)
                if ATTN in (ref_reduced if reduced else ref_config)(arch)
                .pattern()]


def _valid(q_len, window, span):
    """[lo, hi) of a row's valid positions, as the kernel computes it."""
    hi = min(q_len, span)
    lo = max(0, q_len - window) if window > 0 else 0
    return (0, 0) if hi <= lo else (lo, hi)


def test_grid_depends_on_shapes_only():
    assert list(inspect.signature(pa.plan).parameters) == \
        ["T", "H", "KV", "hd", "bs", "nb"]
    # the wrapper's plan for one shape, whatever the lengths and rows
    T, H, KV, hd, bs, nb = 24, 32, 8, 128, 16, 48
    q = torch.zeros((T, H, hd), dtype=torch.bfloat16)
    pool = torch.zeros((9, bs, KV, hd), dtype=torch.bfloat16)
    bt = torch.zeros((4, nb), dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    plans = set()
    for _ in range(4):
        rows = torch.randint(0, 4, (T,), generator=gen, dtype=torch.int32)
        lens = torch.randint(0, nb * bs + 1, (T,), generator=gen,
                             dtype=torch.int32)
        plans.add(pa._check(q, pool, pool, bt, req_rows=rows, q_lens=lens))
    assert plans == {pa.plan(T, H, KV, hd, bs, nb)}
    assert pa.plan(T, H, KV, hd, bs, nb).grid == (T, KV, 3)


@pytest.mark.parametrize("bs", [1, 8, 16, 32])
@pytest.mark.parametrize("nb", [1, 15, 16, 17, 64, 257])
def test_splits_cover_the_span_exactly(bs, nb):
    p = pa.plan(4, 32, 8, 128, bs, nb)
    span, L, S = nb * bs, pa.SPLIT, p.grid[2]
    assert (S - 1) * L < span <= S * L
    assert p.partials == (None if S == 1 else (4, 32, S, 128))
    for window in (0, 7, 300):
        for n in range(0, span + 1, max(1, span // 97)):
            lo, hi = _valid(n, window, span)
            pieces = [(max(lo, z * L), min(hi, (z + 1) * L))
                      for z in range(S)]
            cover = [j for a, b in pieces for j in range(a, b)]
            assert cover == list(range(lo, hi))


@pytest.mark.parametrize("arch,reduced", ATTN_CONFIGS)
def test_every_attention_config_has_a_plan(arch, reduced):
    cfg = (ref_reduced if reduced else ref_config)(arch)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = pa.plan(128, H, KV, hd, 16, 512)
    assert p.tile_rows == pa.TILE_QUERY_ROWS // (H // KV)
    assert p.grid == (128, KV, 32) and p.partials == (128, H, 32, hd)


@pytest.mark.parametrize("G,M", [(1, 64), (3, 21), (4, 16), (6, 10),
                                 (12, 5), (48, 1), (64, 1)])
@pytest.mark.parametrize("nb", [1, 17, 512])
def test_any_group_size_gets_tiles_and_covering_splits(G, M, nb):
    """G need not divide 64: the tile takes M = 64 // G packed rows (at
    most 64 query rows), and the splits still cover the span exactly at
    M = 21, 10 and 5."""
    KV, bs = 2, 16
    p = pa.plan(100, G * KV, KV, 128, bs, nb)
    assert p.tile_rows == M and M * G <= pa.TILE_QUERY_ROWS < (M + 1) * G
    span, S = nb * bs, p.grid[2]
    assert p.grid == (100, KV, S) and (S - 1) * pa.SPLIT < span <= \
        S * pa.SPLIT
    assert p.partials == (None if S == 1 else (100, G * KV, S, 128))


def test_plan_constants_match_the_cuda_source():
    src = SOURCE.read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kSplit"]) == pa.SPLIT
    assert int(const["kRows"]) == pa.TILE_QUERY_ROWS
    built = re.findall(r"case (\d+): return launch_hd<T, \1>", src)
    assert tuple(int(h) for h in built) == pa.HEAD_DIMS


@pytest.mark.parametrize("H,KV,hd", [(32, 8, 16), (24, 8, 136),
                                     (32, 8, 136), (32, 8, 256),
                                     (256, 2, 128), (128, 1, 128),
                                     (32, 6, 128)])
def test_unsupported_shapes_raise(H, KV, hd):
    with pytest.raises(ValueError):
        pa.plan(8, H, KV, hd, 16, 4)
    q = torch.zeros((8, H, hd), dtype=torch.bfloat16)
    pool = torch.zeros((5, 16, KV, hd), dtype=torch.bfloat16)
    idx = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        pa._check(q, pool, pool, torch.zeros((8, 4), dtype=torch.int32),
                  req_rows=idx, q_lens=idx)


@pytest.mark.parametrize("bs,nb", [(12, 4), (0, 4), (16, 0)])
def test_unsupported_block_tables_raise(bs, nb):
    with pytest.raises(ValueError):
        pa.plan(8, 32, 8, 128, bs, nb)
