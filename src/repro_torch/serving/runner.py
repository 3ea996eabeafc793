"""Paged model runner — the reference's ``repro/serving/runner.py``,
eager PyTorch, for attention (dense or mixture-of-experts MLPs), SSM,
hybrid and encoder-decoder stacks.

``submit_batch`` runs ONE mixed step over every scheduled token (decode
singletons and prefill chunks packed along one token axis):

  1. decode rows whose token the host has not seen yet read it from the
     device-resident ``tok_buf`` (``from_buf``);
  2. token embedding, or the host-built prompt embedding (``use_embeds``);
  3. per attention layer: rmsnorm → ``qkv_project`` with the grouped
     LoRA delta over the step's active adapter slots → RoPE; the K/V
     rows are written into the paged pools in place; ragged paged
     attention over each token's own request's blocks; ``out_project``;
     on an encoder-decoder, cross-attention of every row over its own
     request's encoder K/V (read in place over every run slot, so the
     shapes are the bucket's); then the MLP (or MoE) sublayer;
  4. per SSM layer: rmsnorm → ``ssd_ragged_forward``: the input
     projection with its adapter delta, the ragged causal conv and the
     ragged SSD scan, each request's live state gathered at its segment
     start (``row_cols == 0``) and scattered back in place at its last
     token; the post-token states at ``snap_rows`` (prefill block
     boundaries) go to the step's boundary stack for the prefix cache;
  5. final norm → logits of each request's last row → argmax on the
     device → ``tok_buf[run_slots] = sampled`` in place.

Only the sampled int32 ids ever cross to the host, in ``fetch_sampled``
— the one per-step device→host sync — so the engine can submit step
N+1 before it retires step N.  On a card the host staging buffers are
pinned and double-buffered and every upload is ``non_blocking``.

The sequential execution mode (the reference's oracle of the mixed
path) runs ``prefill_chunk`` (one call per prefill chunk: the chunk
attends over its request's cached blocks and itself; SSM layers run the
chunked ``ssd_forward`` from the live state, with the state at every
block boundary) and ``decode_batch`` (one call per decode batch: decode
paged attention, ``ssd_decode_step``).  Their Q/K/V projections are the
fused aLoRA projection over every adapter slot, and both return whole
logits to the host, as the reference's do.

``encode`` runs an encoder-decoder's encoder over one request's frame
embeddings at admission and writes every decoder layer's cross K/V into
the request's run slot of the encoder pools; every later step reads
them there, with no per-step or per-token copy.

Pools (device, updated in place):
  k_pool/v_pool:     (La, NB, bs, KV, hd) — the last block is a write
                                            dump for padded rows; none
                                            when La == 0
  live_ssm/conv:     (Ls, MR, ...)        — per-run-slot SSM state
  snap_ssm/conv:     (Ls, NS, ...)        — block-boundary snapshots
                                            (cross-model state reuse)
  xk_pool/xv_pool:   (La, MR, KV, Se, hd) — per-run-slot encoder K/V,
                                            float32 (values in the model
                                            dtype); enc-dec only
  tok_buf:           (MR,) int32          — last sampled token per run
                                            slot; the last slot is a
                                            dump slot

Sharded (``mesh=``): the runner is one rank of a ``(data, model)`` mesh
(``distributed.parallel.TensorParallel``).  It holds its slice of the
weights (``distributed.sharding.RankLayout``: its query heads and the
K/V heads they read, its d_ff columns or experts, its SSM heads, its
vocab rows), pools of that slice (K/V ``(La, NB, bs, KV/ms, hd)``,
SSM state and conv windows of its heads), and runs the same kernels on
it; the row-parallel sums, the vocab-parallel embedding and the logits'
vocab gather are collectives over ``model``.  With token sharding each
data rank computes its rows of the packed token axis (the bucket is a
multiple of the data axis) and gathers over ``data`` what reads across
rows: the new K/V rows before the pool write (the pools are replicated
over ``data``), the SSM's xBC and dt rows before the conv and scan, the
hidden rows before the logits.  Every rank samples the same ids and
holds the same ``tok_buf``.

The boundary states of a step are a fresh allocation per step, held by
its ``StepHandle``: the engine submits step N+1 before it retires step
N, so a buffer reused across steps would be overwritten.  Snapshot
copies (``snapshot_boundary``, ``snapshot_live``, ``restore_state``,
``reset_live``) and ``encode`` are enqueued on the compute stream, so
they read and write the pools in step order.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import resolve_device, tree_map
from repro_torch.configs.base import ATTN, SSM, ModelConfig
from repro_torch.distributed.parallel import TensorParallel
from repro_torch.distributed.sharding import shard_tree
from repro_torch.models import layers as Lyr
from repro_torch.models import model as M
from repro_torch.models import ssm as ssm_lib
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.attention import (flash_attention,
                                          packed_cross_attention,
                                          ragged_paged_attention)
from repro_torch.obs.tracer import Tracer


def next_pow2(n: int, lo: int = 1) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


# bounded device→host fetch log (``ModelRunner.d2h_fetches``): trim the
# oldest half in bulk at the threshold
D2H_LOG_MAX = 4096
D2H_LOG_KEEP = 2048


def log_d2h(log: List[Tuple[int, str, str]], elems: int, dtype: str,
            tag: str, tracer: Optional[Tracer] = None) -> None:
    """Record one blocking device→host transfer as ``(elems, dtype, tag)``.

    Tags: "step" — the per-step sampled-ids fetch; "admit" — the
    admission-time prompt-embedding copy.  ``tracer`` mirrors the
    transfer into the trace (a "d2h" event plus per-tag counters)."""
    if len(log) >= D2H_LOG_MAX:
        del log[:len(log) - D2H_LOG_KEEP]
    log.append((elems, dtype, tag))
    if tracer is not None and tracer.enabled:
        tracer.event("retire", "d2h", None,
                     {"elems": elems, "dtype": dtype, "tag": tag})
        tracer.count(f"d2h_{tag}_transfers_total")
        tracer.count(f"d2h_{tag}_elems_total", elems)


@dataclass(frozen=True)
class RunnerConfig:
    block_size: int = 16
    num_blocks: int = 512           # incl. 1 reserved dump block
    max_running: int = 9            # incl. 1 reserved dump slot
    num_state_slots: int = 65       # incl. 1 reserved dump slot
    chunk_tokens: int = 64          # max prefill chunk (multiple of bs)


@dataclass
class MixedBatch:
    """One engine step's ragged token batch.

    Per token (T,): ``tok_ids`` (ignored where ``use_embeds`` or
    ``from_buf``), ``embeds`` (T, d) float32, ``use_embeds``,
    ``positions``, ``adapter_idx`` (0 = base), ``req_rows`` (token →
    request row), ``write_bids``/``write_offs`` (where its K/V goes),
    ``from_buf`` (read the token from ``tok_buf`` at its request's run
    slot; None = all host-known), ``row_cols`` (offset in its request's
    segment, 0 = segment start: the SSM state and conv gather point;
    None = all zero, enough for attention-only stacks).
    Per request (R,): ``block_tables`` (ragged lists), ``out_rows`` (the
    row whose hidden state yields the request's logits, and the SSM
    segment-final row), ``run_slots``.
    ``active_slots``: ascending adapter slots the tokens reference.
    ``snap_rows``: packed indices of prefill block-boundary tokens whose
    post-token SSM state is emitted for the prefix cache (None = none)."""
    tok_ids: np.ndarray
    embeds: np.ndarray
    use_embeds: np.ndarray
    positions: np.ndarray
    adapter_idx: np.ndarray
    req_rows: np.ndarray
    write_bids: np.ndarray
    write_offs: np.ndarray
    block_tables: List[List[int]]
    out_rows: np.ndarray
    run_slots: np.ndarray
    active_slots: Optional[np.ndarray] = None
    from_buf: Optional[np.ndarray] = None
    row_cols: Optional[np.ndarray] = None
    snap_rows: Optional[np.ndarray] = None


@dataclass
class StepHandle:
    """An in-flight mixed step: ``sampled`` is the (Rb,) int32 device
    tensor of sampled ids, ``n_requests`` the real row count, and
    ``boundary`` None for attention-only stacks, else the pair
    ``(b_ssm (Ls, Cb, nh, N, P) float32, b_conv (Ls, Cb, W-1, ch))`` of
    post-token states at the batch's ``snap_rows``, in their order."""
    sampled: torch.Tensor
    n_requests: int
    boundary: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.float32): torch.float32,
                 np.dtype(np.bool_): torch.bool}


class HostBufferPool:
    """Persistent capacity-doubling host buffers for per-step batch
    assembly, handed out as numpy views.

    On a card the buffers are pinned, so uploads from them run as
    asynchronous copies.  The pool is DOUBLE-BUFFERED (``flip`` once per
    submitted step): an upload reads its source after the call returns,
    so step N+1 must not refill the buffers step N is still copying
    from.  With one-step-lookahead submission, step N is retired (its
    sampled ids fetched, which waits for the whole step) before step N+2
    reuses its generation.  A deeper pipeline needs more generations."""

    def __init__(self, pin: bool = False):
        self.pin = pin
        self._bufs: dict = {}
        self._gen = 0

    def flip(self) -> None:
        """Advance to the other buffer generation — once per submitted
        step, BEFORE taking that step's staging buffers."""
        self._gen ^= 1

    def take(self, name: str, n: int, dtype, *, trailing: Tuple[int, ...] = (),
             fill=0) -> np.ndarray:
        """A view of ``n`` rows of buffer ``name`` of this generation, set
        to ``fill`` (None: left as it was, for a caller that overwrites
        every element)."""
        key = (name, trailing, np.dtype(dtype).str, self._gen)
        buf = self._bufs.get(key)
        if buf is None or buf.shape[0] < n:
            cap = next_pow2(max(n, 1))
            buf = torch.empty((cap,) + trailing,
                              dtype=_TORCH_DTYPES[np.dtype(dtype)],
                              pin_memory=self.pin).numpy()
            self._bufs[key] = buf
        view = buf[:n]
        if fill is not None:
            view[...] = fill
        return view


class ModelRunner:
    def __init__(self, cfg: ModelConfig, params, rcfg: RunnerConfig,
                 adapter_layers: Optional[List[Any]] = None, *,
                 device="cuda", tracer: Optional[Tracer] = None,
                 mesh=None, data_shard_tokens: bool = True):
        """``adapter_layers``: per-layer slot stacks (normally the
        AdapterPool's ``layers``, written in place as adapters move
        through slots; the rank's slice under a mesh); None for an
        adapter-free runner.  ``mesh``: the ``(data, model)``
        ``DeviceMesh`` this runner is one rank of (``params`` may be the
        full tree or the rank's slice: each leaf is cut before it moves
        to the device); ``data_shard_tokens``: split the packed token
        axis over ``data``."""
        M.check_supported(cfg)
        if cfg.ssm is not None and cfg.ssm.chunk_size != rcfg.block_size:
            # the sequential prefill's SSD chunks end on KV-block
            # boundaries, so its boundary states are the block snapshots
            cfg = cfg.replace(ssm=dataclasses.replace(
                cfg.ssm, chunk_size=rcfg.block_size))
        self.cfg = cfg
        self.rcfg = rcfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.tp: Optional[TensorParallel] = None
        if mesh is None:
            self.params = tree_map(lambda t: t.to(self.device), params)
        else:
            self.tp = TensorParallel(cfg, mesh,
                                     data_shard_tokens=data_shard_tokens)
            self.params = shard_tree(params, self.tp.layout, self.device)
        # the configuration the rank reshapes its heads by
        self.lcfg = cfg if self.tp is None else self.tp.lcfg
        # pow2 token buckets double from the data axis, so its ranks
        # split every bucket evenly
        self._tok_bucket_lo = 1 if self.tp is None else self.tp.token_shards
        self.kinds = list(cfg.pattern())
        self.La = self.kinds.count(ATTN)
        self.Ls = self.kinds.count(SSM)
        self.window = M.effective_window(cfg)
        self.host_bufs = HostBufferPool(pin=self.device.type == "cuda")
        # device calls by step function
        self.call_counts = {"prefill_chunk": 0, "decode_batch": 0,
                            "mixed_step": 0, "encode": 0}
        # host-side assembly time (bucket padding + staging)
        self.t_assembly = 0.0
        # (elements, dtype, tag) of every blocking device→host fetch
        self.d2h_fetches: List[Tuple[int, str, str]] = []
        self.tracer = tracer if tracer is not None \
            else Tracer(enabled=False)
        if adapter_layers is not None:
            if len(adapter_layers) != len(self.kinds):
                raise ValueError("adapter_layers needs one entry per layer")
            self.adapter_layers = adapter_layers
        else:
            self.adapter_layers = [None] * len(self.kinds)
        dtype = Lyr.dtype_of(cfg)
        dev = self.device
        self.k_pool = self.v_pool = None
        if self.La:
            shape = (self.La, rcfg.num_blocks, rcfg.block_size,
                     self.lcfg.num_kv_heads, cfg.head_dim)
            self.k_pool = torch.zeros(shape, dtype=dtype, device=dev)
            self.v_pool = torch.zeros(shape, dtype=dtype, device=dev)
        self.live_ssm = self.live_conv = None
        self.snap_ssm = self.snap_conv = None
        if self.Ls:
            s = cfg.ssm
            _, nh, ch = ssm_lib.ssm_dims(cfg) if self.tp is None \
                else self.tp.layout.ssm_local_dims()
            state = (nh, s.state_dim, s.head_dim)
            window = (s.conv_width - 1, ch)
            MR, NS = rcfg.max_running, rcfg.num_state_slots
            self.live_ssm = torch.zeros((self.Ls, MR) + state,
                                        dtype=torch.float32, device=dev)
            self.live_conv = torch.zeros((self.Ls, MR) + window,
                                         dtype=dtype, device=dev)
            self.snap_ssm = torch.zeros((self.Ls, NS) + state,
                                        dtype=torch.float32, device=dev)
            self.snap_conv = torch.zeros((self.Ls, NS) + window,
                                         dtype=dtype, device=dev)
        self.xk_pool = self.xv_pool = None
        if cfg.is_encoder_decoder:
            shape = (self.La, rcfg.max_running, self.lcfg.num_kv_heads,
                     cfg.encoder_seq_len, cfg.head_dim)
            self.xk_pool = torch.zeros(shape, dtype=torch.float32, device=dev)
            self.xv_pool = torch.zeros(shape, dtype=torch.float32, device=dev)
        self.tok_buf = torch.zeros((rcfg.max_running,), dtype=torch.int32,
                                   device=dev)

    # ------------------------------------------------------------------
    # encoder (encoder-decoder stacks)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def encode(self, frames: np.ndarray, run_slot: int) -> None:
        """Run the encoder over one request's frame embeddings (Se, d)
        and write every decoder layer's projected cross K/V into run slot
        ``run_slot`` of the encoder pools, once per admission."""
        cfg = self.cfg
        shape = (cfg.encoder_seq_len, cfg.d_model)
        if np.shape(frames) != shape:
            raise ValueError(f"frame embeddings {np.shape(frames)}: "
                             f"{cfg.name} takes {shape}")
        self.call_counts["encode"] += 1
        # staged in the pinned host pool and uploaded without waiting:
        # encode runs at admission, while the previous step may still be
        # on the device.  One buffer per run slot, so the admissions of
        # one step never share one.  An admission always submits a step
        # in its iteration (mixed: each submit flips the pool; sequential:
        # each call syncs), so the slot's buffer of this generation is
        # next written two submits on, after the step that followed this
        # upload has retired — the pool's double-buffer rule.
        buf = self.host_bufs.take(f"frames{run_slot}", shape[0], np.float32,
                                  trailing=shape[1:], fill=None)
        buf[...] = frames
        fr = torch.from_numpy(buf).to(self.device, non_blocking=True)
        enc = M.run_encoder(self.params["encoder"], self.lcfg, fr[None],
                            tp=self.tp)
        for ai, (_, lp) in enumerate(M.iter_layers(self.params, cfg)):
            xk, xv = M.encoder_kv(lp, self.lcfg, enc)
            self.xk_pool[ai, run_slot].copy_(xk[0].transpose(0, 1))
            self.xv_pool[ai, run_slot].copy_(xv[0].transpose(0, 1))

    def _cross_attend(self, lp, x: torch.Tensor, ai: int, cross
                      ) -> torch.Tensor:
        """Decoder → encoder cross-attention with its residual.  x: (...,
        d); ``cross`` = (rows, cols, lo, n, n_cols): the query of x's
        flattened row t sits at cell (rows[t], cols[t]) and attends over
        the encoder K/V of run slot lo + rows[t] (of run slots lo..lo+n-1,
        a view of the pools)."""
        cfg = self.lcfg
        rows, cols, lo, n, n_cols = cross
        h = Lyr.rmsnorm(x, lp["xln"], cfg.norm_eps)
        q = (h @ lp["xattn"]["wq"]).reshape(-1, cfg.num_heads, cfg.head_dim)
        o = packed_cross_attention(q, self.xk_pool[ai, lo:lo + n],
                                   self.xv_pool[ai, lo:lo + n], rows, cols,
                                   n_cols)
        return x + self._reduce(Lyr.out_project(lp["xattn"], cfg, o.reshape(
            x.shape[:-1] + o.shape[1:])), "attn")

    def _reduce(self, y: torch.Tensor, part: str) -> torch.Tensor:
        return y if self.tp is None else self.tp.reduce(y, part)

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        tok = self.params["embed"]["tok"]
        return torch.index_select(tok, 0, ids) if self.tp is None \
            else self.tp.embed(tok, ids)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def build_input_embeds(self, prompt: List[int],
                           prefix_embeds: Optional[np.ndarray] = None
                           ) -> np.ndarray:
        """A request's prompt embeddings on the host (float32), built once
        at admission so every later assembly packs rows with slice
        copies.  The device→host copy is logged under "admit".

        ``prefix_embeds`` (P, d), a vision request's patch embeddings,
        replace the leading P rows (the prompt's pseudo-tokens hash them);
        a prompt shorter than P gets the P patch rows alone, as in the
        reference.  The patches are rounded to the model dtype first, so
        that after the step's cast they equal the reference's
        ``pe.astype(emb.dtype)``."""
        ids = torch.as_tensor(  # hotpath: sync-ok (once per admission)
            prompt, dtype=torch.int64, device=self.device)
        emb = self._embed(ids)
        out = emb.float().cpu().numpy()  # hotpath: sync-ok (as above)
        log_d2h(self.d2h_fetches, int(out.size), str(out.dtype), "admit",
                self.tracer)
        if prefix_embeds is not None:
            pe = torch.as_tensor(np.asarray(prefix_embeds)).to(
                emb.dtype).float().numpy()
            out = np.concatenate([pe, out[len(pe):]], axis=0) \
                if len(prompt) >= pe.shape[0] else pe
        return out

    # ------------------------------------------------------------------
    def _assemble_mixed(self, mb: MixedBatch):
        """Host half of :meth:`submit_batch`: pad the ragged batch into
        pow2 buckets in the pooled staging buffers and upload them.
        Returns (the step's tensors, the cross-attention layout of
        :meth:`_cross_attend` or None)."""
        t_host = time.perf_counter()
        self.host_bufs.flip()
        rc = self.rcfg
        T = len(mb.tok_ids)
        R = len(mb.block_tables)
        C = 0 if mb.snap_rows is None else len(mb.snap_rows)
        dump_block = rc.num_blocks - 1
        dump_slot = rc.max_running - 1
        Tb, Rb, Cb, nbb, Kb, *xb = self.buckets(mb)
        take = self.host_bufs.take
        tok = take("tok", Tb, np.int32)
        tok[:T] = mb.tok_ids
        emb = take("emb", Tb, np.float32, trailing=(self.cfg.d_model,))
        emb[:T] = mb.embeds
        use = take("use", Tb, bool)
        use[:T] = mb.use_embeds
        fb = take("fb", Tb, bool)
        if mb.from_buf is not None:
            fb[:T] = mb.from_buf
        pos = take("pos", Tb, np.int32)
        pos[:T] = mb.positions
        # causal length per token; 0 masks padded rows
        qln = take("qln", Tb, np.int32)
        qln[:T] = mb.positions + 1
        ad = take("ad", Tb, np.int32)
        ad[:T] = mb.adapter_idx
        rows = take("rows", Tb, np.int32, fill=Rb - 1)
        rows[:T] = mb.req_rows
        # segment offsets; padded rows are segment starts on the dump slot
        cols = take("cols", Tb, np.int32)
        if mb.row_cols is not None:
            cols[:T] = mb.row_cols
        wb = take("wb", Tb, np.int32, fill=dump_block)
        wb[:T] = mb.write_bids
        wo = take("wo", Tb, np.int32)
        wo[:T] = mb.write_offs
        bt = take("bt", Rb, np.int32, trailing=(nbb,), fill=dump_block)
        for i, t in enumerate(mb.block_tables):
            bt[i, :len(t)] = t
        out_rows = take("out_rows", Rb, np.int32)
        out_rows[:R] = mb.out_rows
        run_slots = take("run_slots", Rb, np.int32, fill=dump_slot)
        run_slots[:R] = mb.run_slots
        tok_slots = take("tok_slots", Tb, np.int32, fill=dump_slot)
        tok_slots[:T] = run_slots[rows[:T]]
        # padding entries read row 0's state, into a discarded stack row
        snap = take("snap", Cb, np.int32)
        if C:
            snap[:C] = mb.snap_rows
        # active adapter slots, pow2-bucketed; padding entries are slot 0
        acts = mb.active_slots if mb.active_slots is not None \
            else np.zeros((0,), np.int32)
        act = take("act", Kb, np.int32)
        act[:len(acts)] = acts
        if xb:
            # cross-attention reads every run slot of the encoder pools in
            # place, so its shapes are the bucket's whatever slots run;
            # row t's query cell is (its run slot, its offset in its
            # segment), padded rows share a spare last column
            xc = take("xc", Tb, np.int32, fill=xb[0] - 1)
            xc[:T] = cols[:T]
        self.t_assembly += time.perf_counter() - t_host

        def upload(a):
            return torch.from_numpy(a).to(self.device, non_blocking=True)

        meta = tuple(map(upload, (tok, emb, use, fb, pos, qln, ad, act, bt,
                                  rows, cols, wb, wo, out_rows, run_slots,
                                  tok_slots, snap)))
        cross = None
        if xb:
            cross = (meta[15], upload(xc), 0, rc.max_running, xb[0])
        return meta, cross

    def buckets(self, mb: MixedBatch) -> Tuple[int, ...]:
        """The pow2 buckets :meth:`_assemble_mixed` pads ``mb`` into:
        tokens, requests, snapshot rows, block-table width and active
        adapter slots; on an encoder-decoder also the cross-attention's
        query columns a run slot (the pow2 of a request's most tokens,
        plus the spare column of the padded rows)."""
        acts = 0 if mb.active_slots is None else len(mb.active_slots)
        snaps = 0 if mb.snap_rows is None else len(mb.snap_rows)
        width = max((len(t) for t in mb.block_tables), default=1)
        out = (next_pow2(max(len(mb.tok_ids), 1), lo=self._tok_bucket_lo),
               next_pow2(max(len(mb.block_tables), 1)),
               next_pow2(max(snaps, 1)), next_pow2(max(width, 1)),
               next_pow2(max(acts, 1)))
        if self.cfg.is_encoder_decoder:
            per = np.bincount(np.asarray(mb.req_rows)).max() \
                if len(mb.req_rows) else 1
            out += (next_pow2(int(per)) + 1,)
        return out

    def _mixed_impl(self, tok, emb, use, fb, pos, qln, ad, act, bt, rows,
                    cols, wb, wo, out_rows, run_slots, tok_slots, snap, *,
                    cross=None) -> Tuple[torch.Tensor, Optional[Tuple]]:
        """The device work of one mixed step (stages 1–5 of the module
        docstring).  Updates the pools and ``tok_buf`` in place and
        returns the (Rb,) int32 sampled ids and the boundary states (a
        fresh pair per step; None without SSM layers).  ``cross``: the
        cross-attention layout of :meth:`_cross_attend` (enc-dec).  On a
        rank of a sharded step, ``x`` holds the rank's ``own`` rows."""
        cfg, lcfg, p, tp = self.cfg, self.lcfg, self.params, self.tp
        own = slice(None) if tp is None else self.tp.rows(tok.shape[0])
        tok = torch.where(fb[own], self.tok_buf[tok_slots[own]], tok[own])
        tok_emb = self._embed(tok)
        x = torch.where(use[own, None], emb[own].to(tok_emb.dtype), tok_emb)
        if cross is not None:
            cross = (cross[0][own], cross[1][own]) + cross[2:]
        boundary = None
        if self.Ls:
            Cb = snap.shape[0]
            boundary = (
                torch.empty((self.Ls, Cb) + self.snap_ssm.shape[2:],
                            dtype=torch.float32, device=self.device),
                torch.empty((self.Ls, Cb) + self.snap_conv.shape[2:],
                            dtype=self.snap_conv.dtype, device=self.device))
        ai = si = 0
        for li, (kind, lp) in enumerate(M.iter_layers(p, cfg)):
            al = self.adapter_layers[li]
            if kind == SSM:
                h = Lyr.rmsnorm(x, lp["ln"], cfg.norm_eps)
                y = ssm_lib.ssd_ragged_forward(
                    lp["ssm"], cfg, h, live_ssm=self.live_ssm[si],
                    live_conv=self.live_conv[si], tok_slots=tok_slots,
                    row_cols=cols, snap_rows=snap, last_rows=out_rows,
                    row_slots=run_slots, snap_ssm_out=boundary[0][si],
                    snap_conv_out=boundary[1][si], alora=al,
                    adapter_idx=ad[own], active_slots=act, tp=tp)
                x = x + y
                si += 1
                continue
            h = Lyr.rmsnorm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = Lyr.qkv_project(lp["attn"], lcfg, h, al, ad[own],
                                      active_slots=act)
            q = Lyr.apply_rope(q, pos[own], cfg.rope_theta)
            k = Lyr.apply_rope(k, pos[own], cfg.rope_theta)
            if tp is not None:
                k, v = self.tp.gather_rows(k), self.tp.gather_rows(v)
            # padded rows all hit (dump_block, 0): duplicate indices, but
            # nothing reads the dump block within a valid q_len
            self.k_pool[ai].index_put_((wb, wo), k)
            self.v_pool[ai].index_put_((wb, wo), v)
            o = ragged_paged_attention(q, self.k_pool[ai], self.v_pool[ai],
                                       bt, rows[own], qln[own],
                                       window=self.window)
            x = x + self._reduce(Lyr.out_project(lp["attn"], lcfg, o), "attn")
            if cross is not None:
                x = self._cross_attend(lp, x, ai, cross)
            x = M.mlp_sublayer(lp, cfg, x, tp=tp)
            ai += 1
        x = Lyr.rmsnorm(x, p["final_norm"], cfg.norm_eps)
        if tp is not None:
            x = self.tp.gather_rows(x)
        logits = M.logits_for(p, cfg, torch.index_select(x, 0, out_rows))
        if tp is not None:
            # the rank's vocab slice → every rank's whole padded row
            logits = self.tp.gather_vocab(logits)
        sampled = torch.argmax(logits, dim=-1).to(torch.int32)
        # padded request rows all target the dump slot
        self.tok_buf.index_put_((run_slots,), sampled)
        return sampled, boundary

    @torch.no_grad()
    def submit_batch(self, mb: MixedBatch) -> StepHandle:
        """Enqueue one mixed step without waiting for it; retire the
        handle with :meth:`fetch_sampled`."""
        meta, cross = self._assemble_mixed(mb)
        self.call_counts["mixed_step"] += 1
        sampled, boundary = self._mixed_impl(*meta, cross=cross)
        return StepHandle(sampled=sampled, n_requests=len(mb.block_tables),
                          boundary=boundary)

    def fetch_sampled(self, handle: StepHandle) -> np.ndarray:
        """Wait for ``handle``'s step and return its sampled ids (R,)
        int32 — the mixed path's only per-step device→host transfer."""
        ids = handle.sampled.cpu().numpy()
        log_d2h(self.d2h_fetches, int(ids.size), str(ids.dtype), "step",
                self.tracer)
        return ids[:handle.n_requests]

    @torch.no_grad()
    def trace_mixed(self, mb: MixedBatch):
        """Record one mixed step of ``mb`` for the step audit (Pass A,
        ``analysis.step_audit``) and return its
        ``analysis.step_trace.StepTrace``, leaving the runner's state as
        it was: the same :meth:`_assemble_mixed` and :meth:`_mixed_impl`
        that :meth:`submit_batch` runs, on clones of the state the step
        updates in place (a past batch's blocks may have been reused
        since).  On a card the assembly and the step run under
        ``torch.cuda.set_sync_debug_mode("error")`` (but on a rank of a
        gloo world, whose collectives synchronise by design).  Call it
        with no step in flight."""
        from repro_torch.analysis.step_trace import IN_PLACE, StepRecording
        saved = {n: getattr(self, n) for n in IN_PLACE
                 if getattr(self, n) is not None}
        try:
            for n, t in saved.items():
                setattr(self, n, t.clone())
            with StepRecording(self, self.buckets(mb)) as rec:
                meta, cross = self._assemble_mixed(mb)
                with rec.recorder:
                    rec.returned(self._mixed_impl(*meta, cross=cross))
                rec.uploaded(meta, cross)
            return rec.trace
        finally:
            for n, t in saved.items():
                setattr(self, n, t)

    def execute_batch(self, mb: MixedBatch) -> np.ndarray:
        """Synchronous submit + fetch; returns the sampled ids (R,)."""
        return self.fetch_sampled(self.submit_batch(mb))

    # ------------------------------------------------------------------
    # sequential execution: one call per prefill chunk, one per decode
    # batch (the reference's oracle of the mixed path)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill_chunk(self, *, input_embeds: np.ndarray, lo: int, hi: int,
                      block_ids: List[int], adapter_idx_row: np.ndarray,
                      run_slot: int
                      ) -> Tuple[torch.Tensor, Optional[Tuple]]:
        """Prefill tokens [lo, hi) of one request from its host prompt
        embeddings (S, d), the chunk padded to a pow2 bucket (at least a
        block) and its table to pow2.  Returns (the logits of token hi-1
        (Vpad,) on the device, the boundary states (b_ssm (Ls, nc, nh, N,
        P), b_conv (Ls, nc, W-1, ch)) at the chunk's block ends, None
        without SSM layers)."""
        self._unsharded("prefill_chunk")
        rc, cfg = self.rcfg, self.cfg
        C = hi - lo
        Cb = next_pow2(C, lo=min(rc.block_size, rc.chunk_tokens))
        x = np.zeros((Cb, cfg.d_model), np.float32)
        x[:C] = input_embeds[lo:hi]
        nbb = next_pow2(max(len(block_ids), 1))
        bt = np.full((nbb,), rc.num_blocks - 1, np.int32)
        bt[:len(block_ids)] = block_ids
        aidx = np.zeros((Cb,), np.int32)
        aidx[:C] = adapter_idx_row
        self.call_counts["prefill_chunk"] += 1
        return self._prefill_impl(self._tensor(x), C, lo, self._tensor(bt),
                                  self._tensor(aidx), run_slot)

    def _unsharded(self, what: str) -> None:
        if self.tp is not None:
            raise ValueError(f"{what}: the sequential mode runs on one "
                             "device; a sharded runner serves the mixed "
                             "step")

    def _prefill_impl(self, x, C: int, lo: int, bt, aidx, slot: int):
        cfg, p, rc = self.cfg, self.params, self.rcfg
        bs, dev = rc.block_size, self.device
        Cb = x.shape[0]
        x = x.to(Lyr.dtype_of(cfg))[None]                    # (1, Cb, d)
        ar = torch.arange(Cb, device=dev)
        gpos = lo + ar
        bids = torch.where(ar < C, bt[(gpos // bs).clamp(max=bt.shape[0] - 1)],
                           rc.num_blocks - 1).long()
        offs = gpos % bs
        cross = (torch.zeros_like(ar), ar, slot, 1, Cb) \
            if cfg.is_encoder_decoder else None
        b_ssm, b_conv = [], []
        ai = si = 0
        for li, (kind, lp) in enumerate(M.iter_layers(p, cfg)):
            al = self.adapter_layers[li]
            if kind == SSM:
                h = Lyr.rmsnorm(x, lp["ln"], cfg.norm_eps)
                y, st, cv, (bnd_s, bnd_c) = ssm_lib.ssd_forward(
                    lp["ssm"], cfg, h, ssm_state=self.live_ssm[si, slot][None],
                    conv_state=self.live_conv[si, slot][None], alora=al,
                    adapter_idx=aidx[None], valid_len=C,
                    return_boundary_states=True)
                self.live_ssm[si, slot].copy_(st[0])
                self.live_conv[si, slot].copy_(cv[0])
                b_ssm.append(bnd_s[:, 0])
                b_conv.append(bnd_c[:, 0])
                x = x + y
                si += 1
                continue
            h = Lyr.rmsnorm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = Lyr.qkv_project(lp["attn"], cfg, h, al, aidx[None])
            q = Lyr.apply_rope(q, gpos[None], cfg.rope_theta)
            k = Lyr.apply_rope(k, gpos[None], cfg.rope_theta)
            # the chunk attends over its request's cached tokens [0, lo)
            # and itself, causally (the reference's ``_chunk_attention``)
            shape = (1, -1, cfg.num_kv_heads, cfg.head_dim)
            past_k = self.k_pool[ai][bt.long()].reshape(shape)[:, :lo]
            past_v = self.v_pool[ai][bt.long()].reshape(shape)[:, :lo]
            o = flash_attention(q, torch.cat([past_k, k], dim=1),
                                torch.cat([past_v, v], dim=1),
                                window=self.window, q_offset=lo)
            x = x + Lyr.out_project(lp["attn"], cfg, o)
            self.k_pool[ai].index_put_((bids, offs), k[0])
            self.v_pool[ai].index_put_((bids, offs), v[0])
            if cross is not None:
                x = self._cross_attend(lp, x, ai, cross)
            x = M.mlp_sublayer(lp, cfg, x)
            ai += 1
        x = Lyr.rmsnorm(x, p["final_norm"], cfg.norm_eps)
        logits = M.logits_for(p, cfg, x[0, max(C - 1, 0)])
        boundary = (torch.stack(b_ssm), torch.stack(b_conv)) if b_ssm \
            else None
        return logits, boundary

    @torch.no_grad()
    def decode_batch(self, *, tokens: np.ndarray, positions: np.ndarray,
                     block_tables: List[List[int]], lengths: np.ndarray,
                     adapter_idx: np.ndarray, run_slots: np.ndarray
                     ) -> np.ndarray:
        """One decode step of a batch of requests, padded to pow2 rows
        (padded rows write the dump block and the dump slot).  Returns
        the (B, Vpad) float32 logits of the real rows on the host."""
        self._unsharded("decode_batch")
        rc = self.rcfg
        B = len(tokens)
        Bb = next_pow2(B)
        dump_block, dump_slot = rc.num_blocks - 1, rc.max_running - 1
        nbb = next_pow2(max(max((len(t) for t in block_tables), default=1),
                            1))
        tok = np.zeros((Bb,), np.int32)
        tok[:B] = tokens
        pos = np.zeros((Bb,), np.int32)
        pos[:B] = positions
        bt = np.full((Bb, nbb), dump_block, np.int32)
        for i, t in enumerate(block_tables):
            bt[i, :len(t)] = t
        ln = np.zeros((Bb,), np.int32)
        ln[:B] = lengths
        ad = np.zeros((Bb,), np.int32)
        ad[:B] = adapter_idx
        rs = np.full((Bb,), dump_slot, np.int32)
        rs[:B] = run_slots
        wb = np.full((Bb,), dump_block, np.int32)
        wo = np.zeros((Bb,), np.int32)
        for i in range(B):
            if block_tables[i]:                  # attention-free: no K/V
                wb[i] = block_tables[i][positions[i] // rc.block_size]
                wo[i] = positions[i] % rc.block_size
        cross = None
        if self.cfg.is_encoder_decoder:
            # one query cell per row (padded rows: the spare column 1)
            lo = int(rs[:B].min())
            xr = np.zeros((Bb,), np.int32)
            xr[:B] = rs[:B] - lo
            xc = np.ones((Bb,), np.int32)
            xc[:B] = 0
            cross = (self._tensor(xr), self._tensor(xc), lo,
                     int(rs[:B].max()) + 1 - lo, 2)
        self.call_counts["decode_batch"] += 1
        logits = self._decode_impl(*map(self._tensor, (tok, pos, bt, ln, ad,
                                                       rs, wb, wo)),
                                   cross=cross)
        return logits[:B].float().cpu().numpy()

    def _decode_impl(self, tok, pos, bt, ln, ad, rs, wb, wo, *, cross):
        cfg, p = self.cfg, self.params
        x = torch.index_select(p["embed"]["tok"], 0, tok)[:, None, :]
        rsl = rs.long()
        ai = si = 0
        for li, (kind, lp) in enumerate(M.iter_layers(p, cfg)):
            al = self.adapter_layers[li]
            if kind == SSM:
                h = Lyr.rmsnorm(x, lp["ln"], cfg.norm_eps)
                y, st, cv = ssm_lib.ssd_decode_step(
                    lp["ssm"], cfg, h, self.live_ssm[si][rsl],
                    self.live_conv[si][rsl], alora=al, adapter_idx=ad[:, None])
                self.live_ssm[si].index_copy_(0, rsl, st)
                self.live_conv[si].index_copy_(0, rsl, cv)
                x = x + y
                si += 1
                continue
            h = Lyr.rmsnorm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = Lyr.qkv_project(lp["attn"], cfg, h, al, ad[:, None])
            q = Lyr.apply_rope(q, pos[:, None], cfg.rope_theta)
            k = Lyr.apply_rope(k, pos[:, None], cfg.rope_theta)
            self.k_pool[ai].index_put_((wb, wo), k[:, 0])
            self.v_pool[ai].index_put_((wb, wo), v[:, 0])
            o = paged_attention(q[:, 0].contiguous(), self.k_pool[ai],
                                self.v_pool[ai], bt, ln, window=self.window)
            x = x + Lyr.out_project(lp["attn"], cfg, o[:, None])
            if cross is not None:
                x = self._cross_attend(lp, x, ai, cross)
            x = M.mlp_sublayer(lp, cfg, x)
            ai += 1
        x = Lyr.rmsnorm(x, p["final_norm"], cfg.norm_eps)
        return M.logits_for(p, cfg, x[:, 0])

    # ------------------------------------------------------------------
    # SSM state snapshots: in-place copies on the compute stream, so they
    # land between the step that wrote the live pool and the next one
    # ------------------------------------------------------------------
    def snapshot_boundary(self, boundary: Tuple[torch.Tensor, torch.Tensor],
                          c_idx: int, slot: int) -> None:
        """Store boundary state ``c_idx`` of a step's stack in ``slot``."""
        b_ssm, b_conv = boundary
        self.snap_ssm[:, slot].copy_(b_ssm[:, c_idx])
        self.snap_conv[:, slot].copy_(b_conv[:, c_idx])

    def snapshot_live(self, run_slot: int, slot: int) -> None:
        """Store run slot ``run_slot``'s live state in ``slot``."""
        self.snap_ssm[:, slot].copy_(self.live_ssm[:, run_slot])
        self.snap_conv[:, slot].copy_(self.live_conv[:, run_slot])

    def restore_state(self, slot: int, run_slot: int) -> None:
        """Load snapshot ``slot`` into run slot ``run_slot``'s live state."""
        self.live_ssm[:, run_slot].copy_(self.snap_ssm[:, slot])
        self.live_conv[:, run_slot].copy_(self.snap_conv[:, slot])

    def reset_live(self, run_slot: int) -> None:
        """Zero run slot ``run_slot``'s live state (a fresh request)."""
        self.live_ssm[:, run_slot].zero_()
        self.live_conv[:, run_slot].zero_()
