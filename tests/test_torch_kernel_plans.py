"""The launch plans of the grouped-LoRA and ragged-SSD kernels, on the CPU.

``repro_torch.kernels.ragged_lora.plan`` and
``repro_torch.kernels.ssd_chunk.ragged_plan`` give each CUDA launch from
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


def _launched(monkeypatch, module, entry, *args):
    """Run ``module._launch(*args)`` on CPU tensors against a stand-in
    library; returns the C entry's arguments by the source's names."""
    calls = []

    def fn(*c_args):
        calls.append(c_args)
        return 0

    monkeypatch.setattr(build, "load",
                        lambda: SimpleNamespace(**{entry: fn}))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=None))
    out = module._launch(*args)
    (c_args,) = calls
    names = _c_params(module.__name__.rsplit(".", 1)[-1] + ".cu", entry)
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
