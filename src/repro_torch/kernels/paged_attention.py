"""Paged attention: the hand-written Hopper kernel that replaces the
reference's two TPU kernels of ``repro/kernels/paged_attention.py``,
with their plain PyTorch versions beside it.

- ``ragged_paged_attention``: one query row per packed token (decode
  singletons and prefill-chunk rows in the same launch); each attends
  over its own request's paged K/V through ``block_tables[req_rows[t]]``,
  causal to ``q_lens[t]``.
- ``paged_attention``: decode, one query per sequence over its own
  table row up to ``lengths[b]``.

Both take an optional sliding window and run an fp32 online softmax.
On the TPU the two share one body; here they share one pair of CUDA
kernels (``repro_torch/csrc/paged_attention.cu``): a planner that writes
a list of work items on the device (one per query tile that holds a
valid key, KV head and piece of the tile's keys; :func:`work_items` is
its plain Python mirror), and a tile kernel of a fixed grid whose blocks
take the items, the block that finishes a cut tile's last piece merging
its pieces.  It reads only the positions that are valid for some row of
a tile, so padding table entries may be any id.  :func:`plan` gives the
launch (grid, tile size, the list's capacity, scratch) from the shapes
alone; the planner adds what it planned to a device counter
(:func:`counts`), read off the step path.

Each wrapper sends a CUDA tensor to the kernel and a CPU tensor to its
plain version; nothing else selects between them.  Each counts its
calls that launch the kernels in ``.launches``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from repro_torch.kernels import build

NEG_INF = -1e30

# the launch plan: the CUDA source's constants of the same meaning
GRID = 132 * 2          # kGrid: the tile kernel's persistent blocks (2 on
                        # each of the H100's 132 SMs)
PLAN_THREADS = 1024     # kPlanThreads: the planner's one block
TILE_QUERY_ROWS = 64    # kRows: query rows (token x query head) per tile
ITEM_KEYS = 8192        # kItemKeys: the most keys one item reads ...
ITEM_BLOCKS = 512       # kItemBlocks: ... and the most table blocks it
                        # spans: min(ITEM_KEYS, ITEM_BLOCKS * bs) keys
MIN_CUT = 128           # kMinCut: the fewest keys of a cut piece
CUT_ALIGN = 64          # kCutAlign: a piece's length is a multiple of this
ROW_KEYS = 16           # kRowKeys: a cut tile's pieces hold at least this
                        # many keys per query row of the tile
# the head sizes it is built for: every attention config of the
# reference's registry, ported or not
HEAD_DIMS = (32, 64, 80, 96, 128, 160)
# the device counts the planner adds to, in order (``counts``)
COUNTS = ("b1_items", "b1_cut_items", "b1_blocks", "b1_old_blocks")


@dataclass(frozen=True)
class Plan:
    """How the kernels cover a call, from the shapes alone.  The planner
    (one block of ``PLAN_THREADS``) writes the work list on the device;
    the tile kernel runs ``grid`` persistent blocks that take its items.
    The CUDA source sizes each block's shared memory (asserting at
    compile time that it fits the card) from the dtype and hd."""
    grid: int                 # the tile kernel's blocks
    tile_rows: int            # M = 64 // G packed rows per tile
    item_keys: int            # the most keys of one item
    items: int                # the work list's capacity
    # fp32 scratch rows of the cut items' partials: hd accumulators and
    # (max, sum) each
    partial_rows: int
    # int32 scratch: a header of 8, the planner's tiles (4 a row), the
    # items (8 each), a counter per (cut tile, KV head)
    work_ints: int


@functools.lru_cache(maxsize=256)
def plan(T: int, H: int, KV: int, hd: int, bs: int, nb: int) -> Plan:
    """The launch of one call with q (T, H, hd), pools (NB, bs, KV, hd)
    and block tables (R, nb).  Raises ``ValueError`` for a shape the
    kernel does not take.

    Capacities.  With ``keys`` the sum of the tiles' key ranges, a piece
    holds ``chunk = min(cap, max(MIN_CUT, KV * keys / (2 * grid)))`` keys
    (rounded up to ``CUT_ALIGN``).  Below ``cap`` the pieces number at
    most ``T + 2 * grid / KV`` and a cut tile's pieces fewer than ``2 *
    len / chunk``, so the cut rows (at most 64 a piece and KV head) fewer
    than ``256 * grid``; at ``cap`` a tile has at most ``ceil(span /
    cap)`` pieces, and only a span past ``cap`` cuts there.  A tile's
    pieces only grow past ``chunk`` (:func:`piece_keys`), so the bounds
    hold for them."""
    if KV <= 0 or H % KV:
        raise ValueError(f"H {H} is not a multiple of KV {KV}")
    G = H // KV
    if G > TILE_QUERY_ROWS:
        raise ValueError(f"G = H / KV = {G} query heads per KV head: the "
                         f"kernel takes G up to {TILE_QUERY_ROWS}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel is built for "
                         f"{HEAD_DIMS}")
    if bs <= 0 or bs & (bs - 1) or nb <= 0:
        raise ValueError(f"block size {bs} must be a power of two and the "
                         f"table width {nb} positive")
    span = nb * bs
    cap = min(ITEM_KEYS, ITEM_BLOCKS * bs)
    per_tile = -(-span // cap)
    pieces = max(T * per_tile, T + -(-2 * GRID // KV))
    items = KV * pieces
    grid = min(GRID, items)
    rows = 4 * TILE_QUERY_ROWS * grid
    if span > cap:
        rows = max(rows, H * T * per_tile)
    return Plan(grid=grid, tile_rows=TILE_QUERY_ROWS // G, item_keys=cap,
                items=items, partial_rows=rows,
                work_ints=8 + 4 * T + 8 * items + KV * T)


class Item(NamedTuple):
    """One item of the work list: the tile's rows ``t0 .. t0 + m - 1``
    against KV head ``kv`` over keys ``[k0, k1)``, piece ``piece`` of the
    tile's ``pieces``; a cut tile's pieces write partial rows from
    ``row`` (``-1``: not cut) and count themselves at ``done``."""
    t0: int
    m: int
    kv: int
    k0: int
    k1: int
    piece: int
    pieces: int
    row: int
    done: int


def work_items(req_rows: Optional[Sequence[int]], q_lens: Sequence[int], *,
               H: int, KV: int, bs: int, nb: int, window: int = 0):
    """The planner's work list, in plain Python and in its order: the
    items and the call's piece length ``chunk`` (a tile's pieces take
    :func:`piece_keys`).  ``req_rows`` None is the
    decode entry (row t reads table row t)."""
    T = len(q_lens)
    G = H // KV
    M = TILE_QUERY_ROWS // G
    span = nb * bs
    grid = plan(T, H, KV, HEAD_DIMS[0], bs, nb).grid   # hd sets no grid
    rows = list(range(T)) if req_rows is None else [int(r) for r in req_rows]

    def valid(t):
        ql = int(q_lens[t])
        hi = min(ql, span)
        lo = max(0, ql - window) if window > 0 else 0
        return (0, 0) if hi <= lo else (lo, hi)

    tiles, t = [], 0
    while t < T:
        m = 1
        while t + m < T and (t + m) % M and rows[t + m] == rows[t]:
            m += 1
        ranges = [valid(r) for r in range(t, t + m) if valid(r)[1] > 0]
        if ranges:
            tiles.append((t, m, min(r[0] for r in ranges),
                          max(r[1] for r in ranges)))
        t += m
    keys = sum(hi - lo for _, _, lo, hi in tiles)
    share = max(-(-keys * KV // (2 * grid)), MIN_CUT)
    chunk = min(-(-share // CUT_ALIGN) * CUT_ALIGN,
                min(ITEM_KEYS, ITEM_BLOCKS * bs))
    items: List[Item] = []
    n_cut = n_rows = 0
    for t0, m, lo, hi in tiles:
        rq = m * G
        size = piece_keys(chunk, rq, bs)
        n = -(-(hi - lo) // size)
        for i in range(n):
            k0 = lo + i * size
            for kv in range(KV):
                items.append(Item(
                    t0, m, kv, k0, min(hi, k0 + size), i, n,
                    n_rows + (i * KV + kv) * rq if n > 1 else -1,
                    n_cut * KV + kv if n > 1 else -1))
        if n > 1:
            n_cut += 1
            n_rows += n * KV * rq
    return items, chunk


def piece_keys(chunk: int, rows: int, bs: int) -> int:
    """The keys of one piece of a tile of ``rows`` query rows, given the
    call's ``chunk``: ``ROW_KEYS`` keys a row at least (whole
    ``CUT_ALIGN`` runs), at most the item's keys."""
    least = -(-rows * ROW_KEYS // CUT_ALIGN) * CUT_ALIGN
    return min(min(ITEM_KEYS, ITEM_BLOCKS * bs), max(chunk, least))


_COUNTS: Dict[torch.device, torch.Tensor] = {}


def counts(device: torch.device) -> torch.Tensor:
    """The device counter the planner adds to on ``device``: int64 (4,)
    in the order of ``COUNTS``.  Read it off the step path only
    (``repro_torch.kernels.bench.b1_counts``): a read is a sync."""
    t = _COUNTS.get(device)
    if t is None:
        t = _COUNTS[device] = torch.zeros(len(COUNTS), dtype=torch.int64,
                                          device=device)
    return t


def ragged_paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_tables: torch.Tensor,
                               req_rows: torch.Tensor, q_lens: torch.Tensor,
                               *, window: int = 0) -> torch.Tensor:
    """Plain version (a port of ``repro/kernels/ref.py``'s
    ``ragged_paged_attention_ref``): gathers each token's K/V rows and
    runs a masked fp32 softmax.

    q: (T, H, hd); k_pool/v_pool: (NB, bs, KV, hd); block_tables: (R, nb)
    int32; req_rows: (T,) int32; q_lens: (T,) int32 causal length per
    token (position + 1; 0 = masked row).  Returns (T, H, hd).  Rows with
    ``q_lens == 0`` hold a uniform average over masked keys — callers
    ignore them (the kernel writes zeros there)."""
    T, H, hd = q.shape
    _, bs, KV, _ = k_pool.shape
    nb = block_tables.shape[1]
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    bt = block_tables.long()[req_rows.long()]               # (T, nb)
    k = k_pool[bt].reshape(T, nb * bs, KV, hd).float()
    v = v_pool[bt].reshape(T, nb * bs, KV, hd).float()
    qr = q.reshape(T, KV, G, hd).float()
    s = torch.einsum("tkgd,tskd->tkgs", qr, k) * scale
    pos = torch.arange(nb * bs, device=q.device)[None, :]
    valid = pos < q_lens[:, None]
    if window > 0:
        valid = valid & (pos > q_lens[:, None] - 1 - window)
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("tkgs,tskd->tkgd", p, v)
    return out.reshape(T, H, hd).to(q.dtype)


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_tables: torch.Tensor,
                        lengths: torch.Tensor, *,
                        window: int = 0) -> torch.Tensor:
    """Plain version of decode attention (a port of
    ``repro/kernels/ref.py``'s ``paged_attention_ref``): the ragged plain
    version with one token per sequence, ``req_rows = arange(B)`` and
    ``q_lens = lengths`` (the two refs are the same function there).

    q: (B, H, hd); k_pool/v_pool: (NB, bs, KV, hd); block_tables: (B, nb)
    int32, padding entries any id; lengths: (B,) int32 valid tokens per
    sequence.  Returns (B, H, hd).  Rows with ``lengths == 0`` hold a
    uniform average over masked keys (the kernel writes zeros there)."""
    rows = torch.arange(q.shape[0], dtype=torch.int32, device=q.device)
    return ragged_paged_attention_ref(q, k_pool, v_pool, block_tables, rows,
                                      lengths, window=window)


def _check(q, k_pool, v_pool, block_tables, **index) -> Plan:
    """Device, dtype, contiguity, alignment and shape checks of one
    kernel call, and its launch plan; ``index`` holds the (T,) int32
    vectors by name.  One pass over the tensors: it runs on every
    launch, on the host, ahead of the kernel."""
    dev, dtype = q.device, q.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {dtype}: the kernel takes float32 or "
                        "bfloat16")
    i32 = torch.int32
    for name, t, want in (("q", q, dtype), ("k_pool", k_pool, dtype),
                          ("v_pool", v_pool, dtype),
                          ("block_tables", block_tables, i32),
                          *((n, t, i32) for n, t in index.items())):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 3 or k_pool.dim() != 4 or block_tables.dim() != 2:
        raise ValueError("expected q (T,H,hd), pools (NB,bs,KV,hd) and "
                         "block_tables (R,nb)")
    T, H, hd = q.shape
    _, bs, KV, hd_k = k_pool.shape
    if v_pool.shape != k_pool.shape or hd_k != hd or H % KV:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    for name, t in index.items():
        if t.shape != (T,):
            raise ValueError(f"{name} must be ({T},), got {tuple(t.shape)}")
    if (q.data_ptr() | k_pool.data_ptr() | v_pool.data_ptr()) % 16:
        raise ValueError("q, k_pool and v_pool must be 16-byte aligned")
    return plan(T, H, KV, hd, bs, block_tables.shape[1])


def _launch(fn, p: Plan, q, k_pool, v_pool, block_tables, *index, window):
    """Run the C entry ``fn`` under plan ``p``: allocates the output, the
    work list and the partials, launches, raises on a launch error."""
    T, H, hd = q.shape
    _, bs, KV, _ = k_pool.shape
    out = torch.empty_like(q)
    if T == 0:
        return out
    work = torch.empty(p.work_ints, dtype=torch.int32, device=q.device)
    part = torch.empty(p.partial_rows * (hd + 2), dtype=torch.float32,
                       device=q.device)
    acc = part.data_ptr()
    err = getattr(build.load(), fn)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), *(t.data_ptr() for t in index),
        out.data_ptr(), work.data_ptr(), acc,
        acc + 4 * p.partial_rows * hd, counts(q.device).data_ptr(), T, H,
        KV, hd, bs, block_tables.shape[1], window, 1.0 / (hd ** 0.5),
        p.grid, p.items, int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, fn)
    return out


def ragged_paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           req_rows: torch.Tensor, q_lens: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """Shapes as in :func:`ragged_paged_attention_ref`.  On a CUDA tensor
    the kernel runs (rows with ``q_lens == 0`` come back as zeros); on a
    CPU tensor the plain version does."""
    if q.device.type == "cpu":
        return build.run_plain("ragged_paged_attention",
                               ragged_paged_attention_ref, q, k_pool, v_pool,
                               block_tables, req_rows, q_lens, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    p = _check(q, k_pool, v_pool, block_tables, req_rows=req_rows,
               q_lens=q_lens)
    out = _launch("ragged_paged_attention", p, q, k_pool, v_pool,
                  block_tables, req_rows, q_lens, window=window)
    if q.shape[0]:
        ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """Decode attention; shapes as in :func:`paged_attention_ref`, with
    ``lengths[b] <= nb * bs``.  On a CUDA tensor the kernel runs (rows
    with ``lengths == 0`` come back as zeros) and reads no block past a
    sequence's length; on a CPU tensor the plain version does."""
    if q.device.type == "cpu":
        return build.run_plain("paged_attention", paged_attention_ref, q,
                               k_pool, v_pool, block_tables, lengths,
                               window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    p = _check(q, k_pool, v_pool, block_tables, lengths=lengths)
    B = q.shape[0]
    if block_tables.shape[0] != B:
        raise ValueError(f"block_tables has {block_tables.shape[0]} rows "
                         f"for {B} sequences")
    out = _launch("paged_attention", p, q, k_pool, v_pool, block_tables,
                  lengths, window=window)
    if B:
        paged_attention.launches += 1
    return out


paged_attention.launches = 0
