"""The launch of the port's paged-attention kernels, on the CPU.

``repro_torch.kernels.paged_attention.plan`` gives the CUDA launch from
the shapes alone: the tile kernel's fixed grid of persistent blocks, the
query-tile size, the work list's capacity and the scratch of cut items.
``work_items`` mirrors the planner that builds the list on the device.
These tests hold the two to what the kernel needs: a launch that no
length changes (a step can be replayed from a CUDA graph per shape
bucket), items that read every (row, query head, valid key) exactly
once and padded rows never, cut tiles whose pieces all reach the merge
within the scratch, a plan for every attention config of the reference's
registry with query tiles of ``64 // G`` rows, the constants the CUDA
source holds, the C entry's arguments, and a ``ValueError`` for a head
size, a G or a block size the kernel does not take.  Each block's shared
memory is sized in the CUDA source, which asserts at compile time that
it fits the card for every head size it is built for."""
import inspect
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro.configs import all_configs as ref_configs
from repro.configs import get_config as ref_config
from repro.configs import get_reduced as ref_reduced
from repro_torch.configs import ATTN
from repro_torch.kernels import build
from repro_torch.kernels import paged_attention as pa
from repro_torch.obs.tracer import Tracer

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


def _check_cover(rows, lens, *, H, KV, bs, nb, window):
    """The planner's items for one call, held to an exact cover: every
    (row, query head, valid key) read once, padded rows by none, tiles of
    at most M rows of one request that cross no multiple of M, and every
    piece of a cut tile present, counted at one counter and writing its
    own partial rows inside the plan's scratch.  Returns the items."""
    T, G, span = len(lens), H // KV, nb * bs
    p = pa.plan(T, H, KV, 128, bs, nb)
    M = p.tile_rows
    items, chunk = pa.work_items(rows, lens, H=H, KV=KV, bs=bs, nb=nb,
                                 window=window)
    req = list(range(T)) if rows is None else list(rows)
    assert len(items) <= p.items
    assert chunk % pa.CUT_ALIGN == 0 or chunk == p.item_keys
    assert pa.MIN_CUT <= chunk <= p.item_keys or chunk == p.item_keys
    reads = {}
    for it in items:
        assert 1 <= it.m <= M and 0 <= it.kv < KV
        assert it.t0 % M + it.m <= M or rows is None
        assert len({req[t] for t in range(it.t0, it.t0 + it.m)}) == 1
        size = pa.piece_keys(chunk, it.m * G, bs)
        assert 0 <= it.k0 < it.k1 <= span and it.k1 - it.k0 <= size
        assert it.pieces == 1 or it.k1 - it.k0 == size or it.piece > 0
        for t in range(it.t0, it.t0 + it.m):
            lo, hi = _valid(lens[t], window, span)
            for g in range(G):
                a, b = max(lo, it.k0), min(hi, it.k1)
                if a < b:
                    reads.setdefault((t, it.kv * G + g), []).append((a, b))
    for t in range(T):
        lo, hi = _valid(lens[t], window, span)
        for h in range(H):
            got = sorted(reads.get((t, h), []))
            # consecutive, non-overlapping pieces of exactly [lo, hi)
            edges = [lo] + [e for ab in got for e in ab] + [hi]
            assert edges[0::2] == edges[1::2] or (lo == hi and not got), \
                (t, h, lo, hi, got)
    # each tile's pieces: all present, in order, in one KV head's rows
    tiles = {}
    for it in items:
        tiles.setdefault((it.t0, it.kv), []).append(it)
    used_rows, used_done = set(), set()
    for (t0, kv), its in tiles.items():
        n = its[0].pieces
        assert [it.piece for it in its] == list(range(n))
        assert [it.k0 for it in its[1:]] == [it.k1 for it in its[:-1]]
        if n == 1:
            assert its[0].row == -1 and its[0].done == -1
            continue
        rq = its[0].m * G
        first = its[0].row
        assert len({it.done for it in its}) == 1
        assert 0 <= its[0].done < KV * T and its[0].done not in used_done
        used_done.add(its[0].done)
        for it in its:
            assert it.row == first + it.piece * KV * rq
            span_rows = set(range(it.row, it.row + rq))
            assert not span_rows & used_rows
            used_rows |= span_rows
            assert it.row + rq <= p.partial_rows
    return items


# ---------------------------------------------------------------------------
# the launch
# ---------------------------------------------------------------------------
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
    assert pa.plan(T, H, KV, hd, bs, nb).grid == pa.GRID
    # no bucket grows the grid: the old one was T * KV * splits blocks
    assert pa.plan(2048, H, KV, hd, bs, 512).grid == pa.GRID


@pytest.mark.parametrize("bs", [1, 8, 16, 32])
@pytest.mark.parametrize("nb", [1, 15, 16, 17, 64, 257])
def test_splits_cover_the_span_exactly(bs, nb):
    """One request's rows at lengths across the whole table span, decode
    singletons (the decode entry) and a prefill run, with no window and
    windows of 7 and 300: the pieces of each tile cover each row's valid
    keys exactly, within the item size the table's shared copy allows."""
    span = nb * bs
    lens = list(range(0, span + 1, max(1, span // 97)))
    for window in (0, 7, 300):
        _check_cover(None, lens, H=32, KV=8, bs=bs, nb=nb, window=window)
        run = list(range(max(1, span - 40), span + 1))
        _check_cover([0] * len(run), run, H=32, KV=8, bs=bs, nb=nb,
                     window=window)
    assert pa.plan(4, 32, 8, 128, bs, nb).item_keys == \
        min(pa.ITEM_KEYS, pa.ITEM_BLOCKS * bs)


@pytest.mark.parametrize("arch,reduced", ATTN_CONFIGS)
def test_every_attention_config_has_a_plan(arch, reduced):
    cfg = (ref_reduced if reduced else ref_config)(arch)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = pa.plan(128, H, KV, hd, 16, 512)
    assert p.tile_rows == pa.TILE_QUERY_ROWS // (H // KV)
    assert p.grid == pa.GRID and p.item_keys == 8192
    assert p.items == KV * (128 + -(-2 * pa.GRID // KV))
    assert p.partial_rows == 4 * pa.TILE_QUERY_ROWS * pa.GRID


@pytest.mark.parametrize("G,M", [(1, 64), (3, 21), (4, 16), (6, 10),
                                 (12, 5), (48, 1), (64, 1)])
@pytest.mark.parametrize("nb", [1, 17, 512])
def test_any_group_size_gets_tiles_and_covering_splits(G, M, nb):
    """G need not divide 64: the tile takes M = 64 // G packed rows (at
    most 64 query rows), and the items still cover each row exactly at
    M = 21, 10 and 5."""
    KV, bs = 2, 16
    p = pa.plan(100, G * KV, KV, 128, bs, nb)
    assert p.tile_rows == M and M * G <= pa.TILE_QUERY_ROWS < (M + 1) * G
    span = nb * bs
    rows = [0] * 60 + [1] * 40
    lens = [min(span, 40 + i) for i in range(60)] + \
        [min(span, i + 1) for i in range(40)]
    items = _check_cover(rows, lens, H=G * KV, KV=KV, bs=bs, nb=nb,
                         window=0)
    assert {it.m for it in items} <= set(range(1, M + 1))
    assert max(it.m for it in items) == min(M, 60)


def test_plan_constants_match_the_cuda_source():
    src = SOURCE.read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = ([\d *]+);", src))
    num = {k: eval(v) for k, v in const.items()}  # products of numbers
    assert num["kGrid"] == pa.GRID
    assert num["kPlanThreads"] == pa.PLAN_THREADS
    assert num["kRows"] == pa.TILE_QUERY_ROWS
    assert num["kItemKeys"] == pa.ITEM_KEYS
    assert num["kItemBlocks"] == pa.ITEM_BLOCKS
    assert num["kMinCut"] == pa.MIN_CUT
    assert num["kCutAlign"] == pa.CUT_ALIGN
    assert num["kRowKeys"] == pa.ROW_KEYS
    built = re.findall(r"case (\d+): return launch_hd<T, \1>", src)
    assert tuple(int(h) for h in built) == pa.HEAD_DIMS
    # the list's layout: a header of 8, 4 ints a tile, 8 an item, then
    # the counters of the cut tiles
    assert "w.tiles = reinterpret_cast<int4*>(base + 8);" in src
    assert "w.items = reinterpret_cast<int4*>(base + 8 + 4 * T_);" in src
    assert "w.done = base + 8 + 4 * T_ + 8 * items;" in src
    # every kernel B1 launches carries the tile kernel's name
    kernels = re.findall(r"__global__ void[^\n]*\n(\w+)\(", src)
    assert kernels == ["paged_attention_tile_kernel_plan",
                       "paged_attention_tile_kernel"]


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


# ---------------------------------------------------------------------------
# the work list
# ---------------------------------------------------------------------------
def _batch(kind, G, nb, bs=16, seed=0):
    """(req_rows, q_lens) of one call over a table of ``nb`` blocks."""
    gen = torch.Generator().manual_seed(seed)
    span = nb * bs

    def ctx(lo, hi):
        return int(torch.randint(lo, hi + 1, (), generator=gen))
    M = pa.TILE_QUERY_ROWS // G
    rows, lens = [], []
    if kind == "mixed":
        # decode singletons, then prefill runs off the tile grid and
        # longer than a tile, then padded rows on the last request row
        for r in range(6):
            rows.append(r)
            lens.append(ctx(1, span))
        for r, n in ((6, M + 3), (7, 2 * M + 1), (8, 5)):
            end = ctx(n, max(n, span))
            rows += [r] * n
            lens += list(range(end - n + 1, end + 1))
        rows += [9] * 11
        lens += [0] * 11
    elif kind == "out_of_order":
        # one request's rows interleaved with another's and not in
        # order of position, and a padded row inside a run
        for i in range(3 * M + 2):
            rows.append(i % 2 if i < 2 * M else 2)
            lens.append(ctx(1, span))
        lens[len(lens) // 2] = 0
    else:                                       # decode: the decode entry
        for _ in range(9):
            lens.append(ctx(0, span))
        return None, lens
    return rows, lens


@pytest.mark.parametrize("G", [1, 2, 3, 4, 6, 8, 12, 64])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("kind", ["mixed", "out_of_order", "decode"])
@pytest.mark.parametrize("nb", [1, 7, 64, 512])
def test_work_items_cover_exactly(G, window, kind, nb):
    KV = 2
    rows, lens = _batch(kind, G, nb, seed=G * 1000 + nb + window)
    _check_cover(rows, lens, H=G * KV, KV=KV, bs=16, nb=nb, window=window)


def _serving_batch(gen, Tb=2048, runs=30, decode=100, nb=512, bs=16):
    """granite's serving bucket: ``runs`` prefill runs of 64 rows at
    contexts up to 6,144, ``decode`` decode rows, padded to ``Tb``."""
    rows, lens = [], []
    for r in range(runs):
        end = int(torch.randint(64, 6145, (), generator=gen))
        rows += [r] * 64
        lens += list(range(end - 63, end + 1))
    for r in range(runs, runs + decode):
        rows.append(r)
        lens.append(int(torch.randint(1, 6145, (), generator=gen)))
    rows += [runs + decode] * (Tb - len(rows))
    lens += [0] * (Tb - len(lens))
    return rows, lens


def test_serving_bucket_runs_on_the_fixed_grid():
    """At granite's serving bucket (T 2,048, a 512-block table) the list
    holds one item per tile and KV head, none cut and none for the 28
    padded rows (the old grid launched T * KV * 32 + T * H = 589,824
    blocks here)."""
    gen = torch.Generator().manual_seed(1)
    rows, lens = _serving_batch(gen)
    items = _check_cover(rows, lens, H=32, KV=8, bs=16, nb=512, window=0)
    assert len(items) == 8 * (30 * 4 + 100)
    assert all(it.pieces == 1 for it in items)


@pytest.mark.parametrize("nb,ctx,T", [(512, 8000, 8), (512, 8000, 1),
                                      (1024, 16000, 64), (2048, 30000, 300)])
def test_long_contexts_cut_within_the_scratch(nb, ctx, T):
    """Few long rows cut to fill the card; rows past the item's keys cut
    at its size (a table wider than 8,192 keys), and many of them, the
    scratch's largest use: all within the plan's capacities."""
    rows = list(range(T))
    lens = [ctx - 7 * t for t in range(T)]
    items = _check_cover(rows, lens, H=32, KV=8, bs=16, nb=nb, window=0)
    assert any(it.pieces > 1 for it in items)
    _check_cover(None, lens, H=32, KV=8, bs=16, nb=nb, window=4096)


def test_work_items_compute_the_attention():
    """The items' pieces, each an fp32 online softmax over its keys and
    merged as the kernel merges cut tiles, give the plain version's
    output (a mixed batch, a window, padded rows as zeros)."""
    gen = torch.Generator().manual_seed(3)
    H, KV, hd, bs, nb = 8, 2, 32, 8, 64
    G = H // KV
    rows, lens = _batch("mixed", G, nb, bs=bs, seed=5)
    T = len(lens)
    NB = len(set(rows)) * nb + 1
    q = torch.randn((T, H, hd), generator=gen)
    kp = torch.randn((NB, bs, KV, hd), generator=gen)
    vp = torch.randn((NB, bs, KV, hd), generator=gen)
    bt = torch.randperm(NB - 1, generator=gen)[:max(rows) * nb + nb] \
        .reshape(-1, nb).to(torch.int32)
    rr = torch.tensor(rows, dtype=torch.int32)
    ql = torch.tensor(lens, dtype=torch.int32)
    for window in (0, 24):
        want = pa.ragged_paged_attention_ref(q, kp, vp, bt, rr, ql,
                                             window=window)
        items, _ = pa.work_items(rows, lens, H=H, KV=KV, bs=bs, nb=nb,
                                 window=window)
        assert any(it.pieces > 1 for it in items) or window
        got = torch.zeros_like(q)
        parts = {}
        for it in items:
            for t in range(it.t0, it.t0 + it.m):
                lo, hi = _valid(lens[t], window, nb * bs)
                if hi == 0:
                    continue
                keys = torch.arange(it.k0, it.k1)
                blk = bt[rows[t]].long()[keys // bs]
                k = kp[blk, keys % bs, it.kv]
                v = vp[blk, keys % bs, it.kv]
                ok = (keys >= lo) & (keys < hi)
                for g in range(G):
                    h = it.kv * G + g
                    s = (k @ q[t, h]) / hd ** 0.5
                    s = torch.where(ok, s, torch.tensor(-float("inf")))
                    mx = s.max()
                    w = torch.exp(s - mx) if ok.any() else torch.zeros_like(s)
                    parts.setdefault((t, h), []).append(
                        (mx, w.sum(), w @ v))
        for (t, h), ps in parts.items():
            mx = max(p[0] for p in ps)
            den = sum(torch.exp(p[0] - mx) * p[1] for p in ps if p[1] > 0)
            num = sum(torch.exp(p[0] - mx) * p[2] for p in ps if p[1] > 0)
            got[t, h] = num / den
        live = ql > 0
        torch.testing.assert_close(got[live], want[live], atol=1e-5,
                                   rtol=1e-5)
        assert not got[~live].any()


# ---------------------------------------------------------------------------
# the C entry and the counter
# ---------------------------------------------------------------------------
def _c_params(entry):
    src = SOURCE.read_text()
    m = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", src, re.S)
    return [re.findall(r"\w+", a)[-1] for a in m.group(1).split(",")]


@pytest.mark.parametrize("entry", ["ragged_paged_attention",
                                   "paged_attention"])
def test_launch_takes_the_plan(monkeypatch, entry):
    """``_launch`` hands the C entry the plan's grid and list capacity,
    the scratch and the wrapper's counter, by the parameter names of the
    source (against a stand-in for the built library)."""
    calls = []

    def fn(*c_args):
        calls.append(c_args)
        return 0
    monkeypatch.setattr(build, "load", lambda: SimpleNamespace(**{entry: fn}))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=None))
    T, H, KV, hd, bs, nb = 40, 32, 8, 128, 16, 96
    q = torch.zeros((T, H, hd), dtype=torch.bfloat16)
    pool = torch.zeros((9, bs, KV, hd), dtype=torch.bfloat16)
    bt = torch.zeros((T, nb), dtype=torch.int32)
    idx = torch.zeros(T, dtype=torch.int32)
    index = (idx, idx) if entry == "ragged_paged_attention" else (idx,)
    p = pa.plan(T, H, KV, hd, bs, nb)
    pa._launch(entry, p, q, pool, pool, bt, *index, window=5)
    (c_args,) = calls
    names = _c_params(entry)
    assert len(c_args) == len(names) == len(build.SIGNATURES[entry])
    c = dict(zip(names, c_args))
    assert c["T" if "T" in c else "B"] == T
    assert (c["H"], c["KV"], c["hd"], c["bs"], c["nb"]) == (H, KV, hd, bs,
                                                            nb)
    assert (c["window"], c["grid"], c["items"], c["is_bf16"]) == \
        (5, p.grid, p.items, 1)
    assert c["counts"] == pa.counts(q.device).data_ptr()
    assert c["part_ml"] - c["part_acc"] == 4 * p.partial_rows * hd
    # nothing is launched for an empty call
    calls.clear()
    pa._launch(entry, pa.plan(0, H, KV, hd, bs, nb), q[:0], pool, pool,
               bt[:0], *(i[:0] for i in index), window=0)
    assert calls == []


def test_counts_are_read_off_the_step_into_the_tracer():
    from repro_torch.kernels.bench import b1_counts
    dev = torch.device("cpu")
    c = pa.counts(dev)
    c += torch.tensor([5, 2, 265, 4096])
    tr = Tracer(enabled=True)
    assert b1_counts(tr) == dict(zip(pa.COUNTS, [5, 2, 265, 4096]))
    assert tr.counters == dict(zip(pa.COUNTS, [5.0, 2.0, 265.0, 4096.0]))
    assert not c.any()
    assert b1_counts() == dict.fromkeys(pa.COUNTS, 0)
    pa._COUNTS.pop(dev)
