"""The launch plans of the grouped-LoRA, ragged-SSD, dense-SSD and fused
aLoRA QKV kernels, on the CPU.

``repro_torch.kernels.ragged_lora.plan``,
``repro_torch.kernels.ssd_chunk.ragged_plan``,
``repro_torch.kernels.ssd_chunk.dense_plan`` and
``repro_torch.kernels.alora_qkv.plan`` give each CUDA launch from
the shapes alone (a step can then be replayed from a CUDA graph per
shape bucket, with no host read of device data).  These tests hold them
to what the kernels need: grids and scratch that no index value changes,
d splits that cover d exactly, a plan for every shape the port's main
paths launch, the constants the CUDA sources hold, a ``ValueError`` for
a shape the kernels do not take, and launches (against a stand-in for
the built library) that pass the plan to the C entry points by their
parameter names in the sources."""
import inspect
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro_torch.configs import ATTN, SSM, _MODULES, get_config, get_reduced
from repro_torch.kernels import alora_qkv as aq
from repro_torch.kernels import build
from repro_torch.kernels import ragged_lora as rl
from repro_torch.kernels import ssd_chunk as sc
from repro_torch.models.ssm import in_proj_dim, ssm_dims

CSRC = Path(rl.__file__).resolve().parents[1] / "csrc"
CONFIGS = [(get_reduced if reduced else get_config)(arch)
           for arch in sorted(_MODULES) for reduced in (False, True)]


def _constants(name):
    """The source's integer constants written as a number or a product
    of numbers."""
    src = (CSRC / name).read_text()
    out = {}
    for k, v in re.findall(r"constexpr int (k\w+) = ([\d *]+);", src):
        out[k] = 1
        for f in v.split("*"):
            out[k] *= int(f)
    return out


def _c_params(source, entry):
    """The parameter names of a C entry point of a CUDA source."""
    src = (CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", src,
                  re.S)
    return [re.findall(r"\w+", a)[-1] for a in m.group(1).split(",")]


def _launched(monkeypatch, module, entry, *args, launch="_launch",
              source=None):
    """Run ``module.<launch>(*args)`` on CPU tensors against a stand-in
    library; returns the C entry's arguments by the names in ``source``
    (by default the module's own ``.cu``)."""
    calls = []

    def fn(*c_args):
        calls.append(c_args)
        return 0

    monkeypatch.setattr(build, "load",
                        lambda: SimpleNamespace(**{entry: fn}))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=None))
    out = getattr(module, launch)(*args)
    (c_args,) = calls
    names = _c_params(source or module.__name__.rsplit(".", 1)[-1] + ".cu",
                      entry)
    assert len(c_args) == len(names) == len(build.SIGNATURES[entry])
    return out, dict(zip(names, c_args))


# ---------------------------------------------------------------------------
# grouped LoRA
# ---------------------------------------------------------------------------
def test_lora_plan_depends_on_shapes_only():
    assert list(inspect.signature(rl.plan).parameters) == \
        ["T", "d", "r", "out_widths", "K"]
    T, d, r, n = 37, 256, 8, 4
    x = torch.zeros((T, d), dtype=torch.bfloat16)
    pairs = [(torch.zeros((n, d, r), dtype=torch.bfloat16),
              torch.zeros((n, r, o), dtype=torch.bfloat16))
             for o in (256, 64, 64)]
    gen = torch.Generator().manual_seed(0)
    plans = set()
    for _ in range(4):
        idx = torch.randint(0, n, (T,), generator=gen, dtype=torch.int32)
        act = torch.randint(0, n, (4,), generator=gen, dtype=torch.int32)
        plans.add(rl._check(x, pairs, idx, act))
    assert plans == {rl.plan(T, d, r, (256, 64, 64), 4)}


@pytest.mark.parametrize("T", [0, 1, 4, 16, 17, 37, 128])
@pytest.mark.parametrize("d", [128, 256, 2560, 4096, 1000])
@pytest.mark.parametrize("outs", [(4096,), (4096, 1024, 1024),
                                  (10576,), (2560, 2560, 2560)])
def test_lora_plan_covers_the_shapes(T, d, outs):
    r = 32
    p = rl.plan(T, d, r, outs, 2)
    tiles, splits, pairs = p.shrink_grid
    assert tiles == -(-T // rl.TILE_ROWS) and pairs == len(outs)
    lo, hi = rl.SPLIT_RANGE
    assert p.split % rl.SPLIT_STEP == 0 and lo <= p.split <= hi
    # the splits cover d exactly, the last one possibly short
    assert (splits - 1) * p.split < d <= splits * p.split
    assert p.scratch == (splits, T, len(outs) * r)
    # each pair's output tiles follow the previous pair's
    assert p.tile0[0] == 0 and p.expand_grid[1] == tiles
    ends = list(p.tile0[1:]) + [p.expand_grid[0]]
    for o, t0, t1 in zip(outs, p.tile0, ends):
        assert (t1 - t0 - 1) * rl.OUT_TILE < o <= (t1 - t0) * rl.OUT_TILE


def test_lora_decode_steps_make_enough_shrink_blocks():
    """A decode step (one token tile) still spreads the shrink over the
    card: at granite's d = 4096 the fused Q/K/V call makes 96 blocks."""
    p = rl.plan(4, 4096, 32, (4096, 1024, 1024), 1)
    assert p.shrink_grid == (1, 32, 3)
    assert rl.plan(128, 4096, 32, (4096, 1024, 1024), 2).shrink_grid == \
        (8, 8, 3)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
@pytest.mark.parametrize("r", rl.RANKS)
def test_every_config_has_a_lora_plan(cfg, r):
    kinds = cfg.pattern()
    if ATTN in kinds:
        rl.plan(128, cfg.d_model, r, (cfg.num_heads * cfg.head_dim,
                                      cfg.num_kv_heads * cfg.head_dim,
                                      cfg.num_kv_heads * cfg.head_dim), 2)
    if SSM in kinds:
        rl.plan(128, cfg.d_model, r, (in_proj_dim(cfg),), 2)


@pytest.mark.parametrize("T,d,r,outs", [
    (4, 4096, 32, (4096, 1024, 1024)),
    (37, 2560, 8, (2560, 2560, 2560)),
    (128, 2560, 256, (10576,)),
])
def test_lora_launch_takes_the_plan(monkeypatch, T, d, r, outs):
    """The C entry launches the plan's grids, split and tiles, and the
    scratch has the plan's shape."""
    n = 3
    x = torch.zeros((T, d), dtype=torch.bfloat16)
    pairs = [(torch.zeros((n, d, r), dtype=torch.bfloat16),
              torch.zeros((n, r, o), dtype=torch.bfloat16)) for o in outs]
    idx = torch.ones(T, dtype=torch.int32)
    act = torch.tensor([1, 2], dtype=torch.int32)
    outs_, c = _launched(monkeypatch, rl, "ragged_grouped_lora", x, pairs,
                         idx, act)
    p = rl.plan(T, d, r, outs, 2)
    assert [o.shape for o in outs_] == [(T, o) for o in outs]
    assert (c["tiles"], c["n_split"], c["n_pairs"]) == p.shrink_grid
    assert (c["out_tiles"], c["tiles"]) == p.expand_grid
    assert c["split"] == p.split
    assert tuple(c[f"tile0_{i}"] for i in range(len(outs))) == p.tile0
    assert (c["T"], c["d"], c["r"], c["n_slots"], c["K"]) == (T, d, r, n, 2)
    assert [c[f"out_dim{i}"] for i in range(3)] == \
        list(outs) + [0] * (3 - len(outs))


def test_lora_plan_constants_match_the_cuda_source():
    const = _constants("ragged_lora.cu")
    assert const["kRows"] == rl.TILE_ROWS
    assert const["kOutTile"] == rl.OUT_TILE
    assert const["kMaxPairs"] == rl.MAX_PAIRS
    assert const["kSplitStep"] == rl.SPLIT_STEP
    assert const["kMaxSplit"] == rl.SPLIT_RANGE[1]


@pytest.mark.parametrize("T,d,r,outs,K", [
    (8, 4096, 24, (4096,), 2),              # rank not a pow2 bucket
    (8, 4096, 4, (4096,), 2),               # rank below 8
    (8, 4096, 512, (4096,), 2),             # rank above 256
    (8, 4100, 32, (4096,), 2),              # d not a multiple of 8
    (8, 4096, 32, (4090,), 2),              # width not a multiple of 8
    (8, 4096, 32, (), 2),                   # no pair
    (8, 4096, 32, (64, 64, 64, 64), 2),     # four pairs
    (-1, 4096, 32, (4096,), 2),
])
def test_lora_unsupported_shapes_raise(T, d, r, outs, K):
    with pytest.raises(ValueError):
        rl.plan(T, d, r, outs, K)


def test_lora_check_rejects_mismatched_pairs():
    x = torch.zeros((4, 64), dtype=torch.float32)
    a = torch.zeros((3, 64, 8))
    with pytest.raises(ValueError, match="one slot count and rank"):
        rl._check(x, [(a, torch.zeros((3, 8, 16))),
                      (torch.zeros((3, 64, 16)), torch.zeros((3, 16, 16)))],
                  torch.zeros(4, dtype=torch.int32),
                  torch.zeros(2, dtype=torch.int32))


# ---------------------------------------------------------------------------
# ragged SSD scan
# ---------------------------------------------------------------------------
def test_scan_plan_depends_on_shapes_only():
    assert list(inspect.signature(sc.ragged_plan).parameters) == \
        ["T", "H", "N", "P", "M"]
    T, H, N, P, S, M = 37, 3, 16, 32, 5, 6
    f = torch.zeros
    args = (f((T, H, P)), f((T, H, N)), f((T, H, N)), f((T, H)), f((T, H)))
    gen = torch.Generator().manual_seed(0)
    plans = set()
    for _ in range(4):
        starts = torch.randint(0, 2, (T,), generator=gen, dtype=torch.int32)
        slots = torch.randint(0, S, (T,), generator=gen, dtype=torch.int32)
        rows = torch.randint(0, T, (M,), generator=gen, dtype=torch.int32)
        plans.add(sc._check(*args, starts, slots, f((S, H, N, P)), rows))
    assert plans == {sc.ragged_plan(T, H, N, P, M)}


@pytest.mark.parametrize("T", [0, 1, 4, 16, 17, 128])
@pytest.mark.parametrize("N,P", [(16, 32), (64, 64), (128, 64), (128, 40)])
def test_scan_plan_covers_the_shapes(T, N, P):
    p = sc.ragged_plan(T, 80, N, P, 16)
    assert p.grid == (80, -(-P // sc.SCAN_COLS))
    # the column tiles cover P exactly, the last one possibly short
    assert (p.grid[1] - 1) * sc.SCAN_COLS < P <= p.grid[1] * sc.SCAN_COLS


@pytest.mark.parametrize("T,N,P,M", [(37, 16, 40, 6), (128, 128, 64, 16)])
def test_scan_launch_takes_the_plan(monkeypatch, T, N, P, M):
    """The C entry launches the plan's grid."""
    H, S = 3, 5
    f = torch.zeros
    args = (f((T, H, P)), f((T, H, N)), f((T, H, N)), f((T, H)), f((T, H)),
            torch.ones(T, dtype=torch.int32), f(T, dtype=torch.int32),
            f((S, H, N, P)), f(M, dtype=torch.int32))
    (y, states), c = _launched(monkeypatch, sc, "ragged_ssd_chunk_scan",
                               *args)
    assert y.shape == (T, H, P) and states.shape == (M, H, N, P)
    assert (c["grid_h"], c["grid_p"]) == sc.ragged_plan(T, H, N, P, M).grid
    assert (c["T"], c["H"], c["N"], c["P"], c["M"]) == (T, H, N, P, M)


def test_scan_with_no_tokens_launches_nothing_and_gives_zero_states(
        monkeypatch):
    monkeypatch.setattr(build, "load", lambda: pytest.fail("launched"))
    f = torch.zeros
    y, states = sc._launch(f((0, 2, 8)), f((0, 2, 16)), f((0, 2, 16)),
                           f((0, 2)), f((0, 2)), f(0, dtype=torch.int32),
                           f(0, dtype=torch.int32), f((3, 2, 16, 8)),
                           f(2, dtype=torch.int32))
    assert y.shape == (0, 2, 8)
    assert torch.equal(states, torch.zeros((2, 2, 16, 8)))


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_every_ssm_config_has_a_scan_plan(cfg):
    if cfg.ssm is None:
        return
    _, nh, _ = ssm_dims(cfg)
    # the runner's kept rows: request rows and snapshot rows, pow2
    p = sc.ragged_plan(128, nh, cfg.ssm.state_dim, cfg.ssm.head_dim, 64)
    assert p.grid[0] == nh


def test_scan_plan_constants_match_the_cuda_source():
    const = _constants("ssd_chunk.cu")
    src = (CSRC / "ssd_chunk.cu").read_text()
    # kBlockCols = kWarps * kCols, kCols = 32 / kGroups * kLaneCols,
    # kGroups = 1 << kGroupBits
    groups = 1 << const["kGroupBits"]
    assert const["kWarps"] * 32 // groups * const["kLaneCols"] \
        == sc.SCAN_COLS
    built = re.findall(r"case (\d+): return launch_nr<(\d+)>", src)
    assert tuple(int(n) for n, _ in built) == sc.SCAN_STATE_DIMS
    assert all(int(n) == groups * int(nr) for n, nr in built)


@pytest.mark.parametrize("T,H,N,P,M", [
    (8, 4, 256, 64, 4),      # N above the kernel's 128
    (8, 4, 48, 64, 4),       # N not a built size
    (8, 4, 128, 60, 4),      # P not a multiple of 8
    (8, 0, 128, 64, 4),
    (8, 4, 128, 64, -1),
])
def test_scan_unsupported_shapes_raise(T, H, N, P, M):
    with pytest.raises(ValueError):
        sc.ragged_plan(T, H, N, P, M)


# ---------------------------------------------------------------------------
# dense SSD scan (the kernel bench's)
# ---------------------------------------------------------------------------
# the bench's shapes (mamba2-2.7b, zamba2-2.7b, the reduced SSM models'
# N = 16) and chip_smoke.py's phase-5 edges: S off the chunks, P off the
# warp slices, Bt * H below and above the 132 SMs
DENSE_SHAPES = [(2, 2048, 80, 128, 64), (2, 2048, 80, 64, 64),
                (2, 64, 8, 16, 32)] + [
    (2, S, H, N, 40) for N in (16, 32, 64, 128) for S in (70, 130)
    for H in (3, 70)]


def test_dense_plan_depends_on_shapes_only():
    assert list(inspect.signature(sc.dense_plan).parameters) == \
        ["Bt", "S", "H", "N", "P"]


@pytest.mark.parametrize("Bt,S,H,N,P", DENSE_SHAPES)
def test_dense_plan_covers_the_shapes(Bt, S, H, N, P):
    p = sc.dense_plan(Bt, S, H, N, P)
    H_, slices, Bt_ = p.grid
    assert (H_, Bt_) == (H, Bt)
    # every block covers real columns of P: the last slice may be short
    assert p.cols % sc.DENSE_WARP_COLS == 0
    assert 0 < p.cols <= sc.DENSE_MAX_COLS
    assert (slices - 1) * p.cols < P <= slices * p.cols
    assert p.chunk == sc.DENSE_CHUNK and p.stages in sc.DENSE_STAGES
    # two blocks share an SM's shared memory
    assert p.smem == sc.dense_smem(N, p.cols, p.stages)
    assert p.smem <= sc.DENSE_SMEM_TARGET <= 227 * 1024 // 2
    if Bt * H >= sc.SMS:    # enough (row, head) walks: C . B^T once each
        assert slices == -(-P // sc.DENSE_MAX_COLS)
    else:                   # P cut into slices to fill the SMs
        assert slices > 1


def test_dense_plan_at_the_bench_shapes():
    p128 = sc.dense_plan(2, 2048, 80, 128, 64)
    p64 = sc.dense_plan(2, 2048, 80, 64, 64)
    assert p128.grid == p64.grid == (80, 1, 2)
    assert p128.cols == p64.cols == 64
    assert (p128.stages, p64.stages) == (2, 3)


def test_dense_plan_constants_match_the_cuda_source():
    const = _constants("ssd_chunk_dense.cu")
    assert const["kWarpCols"] == sc.DENSE_WARP_COLS
    assert const["kWarpCols"] * const["kMaxWarps"] == sc.DENSE_MAX_COLS
    src = (CSRC / "ssd_chunk_dense.cu").read_text()
    assert int(re.search(r"constexpr int Q = (\d+);", src).group(1)) \
        == sc.DENSE_CHUNK
    # kTiles = (Q / 16) * (Q / 16 + 1)
    assert (sc.DENSE_CHUNK // 16) * (sc.DENSE_CHUNK // 16 + 1) \
        == sc.DENSE_TILES
    built = {int(n) for n in re.findall(r"case (\d+): return launch<", src)}
    assert built == set(sc.DENSE_N)


@pytest.mark.parametrize("Bt,S,H,N,P", [
    (2, 64, 3, 24, 64),       # N not a built size
    (2, 64, 3, 256, 64),      # N above 128
    (2, 64, 3, 48, 64),
    (2, 64, 3, 64, 60),       # P not a multiple of 8
    (2, 64, 3, 64, 0),
    (0, 64, 3, 64, 64),
    (2, 64, 0, 64, 64),
    (2, -1, 3, 64, 64),
])
def test_dense_unsupported_shapes_raise(Bt, S, H, N, P):
    with pytest.raises(ValueError):
        sc.dense_plan(Bt, S, H, N, P)


@pytest.mark.parametrize("Bt,S,H,N,P", [(2, 70, 3, 32, 40),
                                        (1, 130, 70, 128, 64)])
def test_dense_launch_takes_the_plan(monkeypatch, Bt, S, H, N, P):
    f = torch.zeros
    args = (f((Bt, S, H, P)), f((Bt, S, H, N)), f((Bt, S, H, N)),
            f((Bt, S, H)), f((Bt, S, H)))
    (y, st), c = _launched(monkeypatch, sc, "ssd_chunk_scan", *args,
                           launch="_launch_dense",
                           source="ssd_chunk_dense.cu")
    p = sc.dense_plan(Bt, S, H, N, P)
    assert y.shape == (Bt, S, H, P) and st.shape == (Bt, H, N, P)
    assert (c["chunk"], c["ps"], c["slices"], c["stages"]) == \
        (p.chunk, p.cols, p.grid[1], p.stages)
    assert (c["Bt"], c["S"], c["H"], c["N"], c["P"]) == (Bt, S, H, N, P)


def test_dense_scan_with_no_tokens_launches_nothing(monkeypatch):
    monkeypatch.setattr(build, "load", lambda: pytest.fail("launched"))
    f = torch.zeros
    y, st = sc._launch_dense(f((2, 0, 3, 8)), f((2, 0, 3, 32)),
                             f((2, 0, 3, 32)), f((2, 0, 3)), f((2, 0, 3)))
    assert y.shape == (2, 0, 3, 8)
    assert torch.equal(st, torch.zeros((2, 3, 32, 8)))


# ---------------------------------------------------------------------------
# fused aLoRA QKV projection (the kernel bench's)
# ---------------------------------------------------------------------------
BF16, F32 = torch.bfloat16, torch.float32
# the bench's shapes (granite-3.2-8b's fused Q/K/V, four rank-32
# adapters) and chip_smoke.py's phase-5 edges
ALORA_SHAPES = [(512, 4096, 6144, 32, 4, BF16), (128, 4096, 6144, 32, 4, BF16),
                (128, 4096, 6144, 32, 4, F32)] + [
    (T, 264, out, r, 5, dt) for T in (1, 100, 130, 300)
    for out in (200, 6144) for r in (8, 32) for dt in (BF16, F32)]


def test_alora_plan_depends_on_shapes_only():
    assert list(inspect.signature(aq.plan).parameters) == \
        ["T", "d", "out", "r", "n", "dtype"]


@pytest.mark.parametrize("T,d,out,r,n,dtype", ALORA_SHAPES)
def test_alora_plan_covers_the_shapes(T, d, out, r, n, dtype):
    p = aq.plan(T, d, out, r, n, dtype)
    mt, nt, split = p.grid
    # every block covers a real tile and a non-empty run of k steps
    assert (mt - 1) * p.bm < T <= mt * p.bm
    assert (nt - 1) * p.bn < out <= nt * p.bn
    assert 1 <= split <= p.ksteps == -(-d // (aq.ROW_BYTES // (
        2 if dtype == BF16 else 4)))
    assert p.bm == (64 if T <= 64 else 128)
    assert p.bn in aq.TILES[dtype]
    assert p.rp % aq.RANK_STEP == 0 and r <= p.rp < r + aq.RANK_STEP
    assert p.smem == aq.tile_smem(p.bm, p.bn, p.stages) <= aq.MAX_SMEM
    assert p.stages in (2, 3, 4)
    if split > 1 and dtype == BF16:
        assert p.smem <= aq.PAIR_SMEM    # two blocks to an SM
    assert (p.reduce_blocks > 0) == (split > 1)
    # the shrink: d runs of kc cover d, every run non-empty
    kc, xs = p.shrink_kc, p.shrink_split
    assert kc % 64 == 0 and (xs - 1) * kc < d <= xs * kc
    assert p.shrink_grid == (-(-T // aq.SHRINK_ROWS), xs, n - 1)
    assert p.shrink_smem == aq.shrink_smem(
        2 if dtype == BF16 else 4, kc, p.rp) <= aq.MAX_SMEM


def test_alora_plan_at_the_bench_shapes():
    p512 = aq.plan(512, 4096, 6144, 32, 4, BF16)
    assert (p512.bm, p512.bn, p512.grid) == (128, 192, (4, 32, 1))
    p128 = aq.plan(128, 4096, 6144, 32, 4, BF16)
    # W's bytes bound it: at least 132 blocks stream W
    assert p128.bn == 128 and p128.grid[2] > 1
    assert p128.grid[0] * p128.grid[1] * p128.grid[2] >= aq.SMS
    f128 = aq.plan(128, 4096, 6144, 32, 4, F32)
    # float32: one block to an SM, whole waves
    assert f128.grid[2] > 1
    assert f128.grid[0] * f128.grid[1] * f128.grid[2] <= aq.SMS


def test_alora_plan_constants_match_the_cuda_source():
    const = _constants("alora_qkv.cu")
    assert const["kShrinkRows"] == aq.SHRINK_ROWS
    assert const["kRowBytes"] == aq.ROW_BYTES
    assert const["kReduceThreads"] == aq.REDUCE_THREADS
    src = (CSRC / "alora_qkv.cu").read_text()
    built = {(int(m), int(n)) for m, n in
             re.findall(r"launch_tile<T, (\d+), (\d+)>", src)}
    want = {(bm, bn) for dt in aq.TILES for bn in aq.TILES[dt]
            for bm in (64, 128) if bn == 128 or bm == 128}
    assert built == want


@pytest.mark.parametrize("T,d,out,r,n,dtype", [
    (8, 260, 64, 8, 2, BF16),      # d not a multiple of 8
    (8, 64, 60, 8, 2, BF16),       # out not a multiple of 8
    (8, 64, 64, 0, 2, BF16),
    (8, 64, 64, 257, 2, BF16),     # rank above 256
    (0, 64, 64, 8, 2, BF16),
    (8, 64, 64, 8, 0, BF16),
    (8, 64, 64, 8, 2, torch.float16),
])
def test_alora_unsupported_shapes_raise(T, d, out, r, n, dtype):
    with pytest.raises(ValueError):
        aq.plan(T, d, out, r, n, dtype)


@pytest.mark.parametrize("T,d,out,r,n,dtype", [(1, 264, 200, 8, 5, BF16),
                                               (128, 4096, 6144, 32, 4, F32),
                                               (300, 264, 6144, 5, 3, BF16)])
def test_alora_launch_takes_the_plan(monkeypatch, T, d, out, r, n, dtype):
    f = torch.zeros
    x = f((T, d), dtype=dtype)
    args = (x, f((d, out), dtype=dtype), f((n, d, r), dtype=dtype),
            f((n, r, out), dtype=dtype), f(T, dtype=torch.int32),
            torch.empty((T, out), dtype=dtype))
    _, c = _launched(monkeypatch, aq, "alora_qkv", *args)
    p = aq.plan(T, d, out, r, n, dtype)
    assert (c["rp"], c["bm"], c["bn"], c["stages"], c["split"],
            c["ksteps"]) == (p.rp, p.bm, p.bn, p.stages, p.split, p.ksteps)
    assert (c["xa_split"], c["xa_kc"], c["xa_blocks"],
            c["reduce_blocks"]) == (p.shrink_split, p.shrink_kc,
                                    p.xa_blocks, p.reduce_blocks)
    assert (c["T"], c["d"], c["out_dim"], c["n"], c["r"], c["is_bf16"]) \
        == (T, d, out, n, r, int(dtype == BF16))
