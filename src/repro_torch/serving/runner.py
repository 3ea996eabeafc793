"""Paged model runner — the mixed path of the reference's
``repro/serving/runner.py``, eager PyTorch, for attention (dense or
mixture-of-experts MLPs), SSM and hybrid stacks.

``submit_batch`` runs ONE mixed step over every scheduled token (decode
singletons and prefill chunks packed along one token axis):

  1. decode rows whose token the host has not seen yet read it from the
     device-resident ``tok_buf`` (``from_buf``);
  2. token embedding, or the host-built prompt embedding (``use_embeds``);
  3. per attention layer: rmsnorm → ``qkv_project`` with the grouped
     LoRA delta over the step's active adapter slots → RoPE; the K/V
     rows are written into the paged pools in place; ragged paged
     attention over each token's own request's blocks; ``out_project``,
     then the MLP (or MoE) sublayer;
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

Pools (device, updated in place):
  k_pool/v_pool:     (La, NB, bs, KV, hd) — the last block is a write
                                            dump for padded rows; none
                                            when La == 0
  live_ssm/conv:     (Ls, MR, ...)        — per-run-slot SSM state
  snap_ssm/conv:     (Ls, NS, ...)        — block-boundary snapshots
                                            (cross-model state reuse)
  tok_buf:           (MR,) int32          — last sampled token per run
                                            slot; the last slot is a
                                            dump slot

The boundary states of a step are a fresh allocation per step, held by
its ``StepHandle``: the engine submits step N+1 before it retires step
N, so a buffer reused across steps would be overwritten.  Snapshot
copies (``snapshot_boundary``, ``snapshot_live``, ``restore_state``,
``reset_live``) are enqueued on the compute stream, so they read and
write the pools in step order.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import resolve_device, tree_map
from repro_torch.configs.base import ATTN, SSM, ModelConfig
from repro_torch.models import layers as Lyr
from repro_torch.models import model as M
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import ragged_paged_attention
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
        key = (name, trailing, np.dtype(dtype).str, self._gen)
        buf = self._bufs.get(key)
        if buf is None or buf.shape[0] < n:
            cap = next_pow2(max(n, 1))
            buf = torch.empty((cap,) + trailing,
                              dtype=_TORCH_DTYPES[np.dtype(dtype)],
                              pin_memory=self.pin).numpy()
            self._bufs[key] = buf
        view = buf[:n]
        view[...] = fill
        return view


class ModelRunner:
    def __init__(self, cfg: ModelConfig, params, rcfg: RunnerConfig,
                 adapter_layers: Optional[List[Any]] = None, *,
                 device="cuda", tracer: Optional[Tracer] = None):
        """``adapter_layers``: per-layer slot stacks (normally the
        AdapterPool's ``layers``, written in place as adapters move
        through slots); None for an adapter-free runner."""
        M.check_supported(cfg)
        self.cfg = cfg
        self.rcfg = rcfg
        self.device = resolve_device(device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.kinds = list(cfg.pattern())
        self.La = self.kinds.count(ATTN)
        self.Ls = self.kinds.count(SSM)
        self.window = M.effective_window(cfg)
        self.host_bufs = HostBufferPool(pin=self.device.type == "cuda")
        self.call_counts = {"mixed_step": 0}
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
                     cfg.num_kv_heads, cfg.head_dim)
            self.k_pool = torch.zeros(shape, dtype=dtype, device=dev)
            self.v_pool = torch.zeros(shape, dtype=dtype, device=dev)
        self.live_ssm = self.live_conv = None
        self.snap_ssm = self.snap_conv = None
        if self.Ls:
            s = cfg.ssm
            _, nh, ch = ssm_lib.ssm_dims(cfg)
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
        self.tok_buf = torch.zeros((rcfg.max_running,), dtype=torch.int32,
                                   device=dev)

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
        ids = torch.as_tensor(prompt, dtype=torch.int64, device=self.device)
        emb = torch.index_select(self.params["embed"]["tok"], 0, ids)
        out = emb.float().cpu().numpy()
        log_d2h(self.d2h_fetches, int(out.size), str(out.dtype), "admit",
                self.tracer)
        if prefix_embeds is not None:
            pe = torch.as_tensor(np.asarray(prefix_embeds)).to(
                emb.dtype).float().numpy()
            out = np.concatenate([pe, out[len(pe):]], axis=0) \
                if len(prompt) >= pe.shape[0] else pe
        return out

    # ------------------------------------------------------------------
    def _assemble_mixed(self, mb: MixedBatch) -> Tuple[torch.Tensor, ...]:
        """Host half of :meth:`submit_batch`: pad the ragged batch into
        pow2 buckets in the pooled staging buffers and upload them."""
        t_host = time.perf_counter()
        self.host_bufs.flip()
        rc = self.rcfg
        T = len(mb.tok_ids)
        R = len(mb.block_tables)
        C = 0 if mb.snap_rows is None else len(mb.snap_rows)
        dump_block = rc.num_blocks - 1
        dump_slot = rc.max_running - 1
        Tb = next_pow2(max(T, 1))
        Rb = next_pow2(max(R, 1))
        Cb = next_pow2(max(C, 1))
        nbb = next_pow2(max(max((len(t) for t in mb.block_tables),
                                default=1), 1))
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
        act = take("act", next_pow2(max(len(acts), 1)), np.int32)
        act[:len(acts)] = acts
        self.t_assembly += time.perf_counter() - t_host
        return tuple(torch.from_numpy(a).to(self.device, non_blocking=True)
                     for a in (tok, emb, use, fb, pos, qln, ad, act, bt, rows,
                               cols, wb, wo, out_rows, run_slots, tok_slots,
                               snap))

    def _mixed_impl(self, tok, emb, use, fb, pos, qln, ad, act, bt, rows,
                    cols, wb, wo, out_rows, run_slots, tok_slots, snap
                    ) -> Tuple[torch.Tensor, Optional[Tuple]]:
        """The device work of one mixed step (stages 1–5 of the module
        docstring).  Updates the pools and ``tok_buf`` in place and
        returns the (Rb,) int32 sampled ids and the boundary states (a
        fresh pair per step; None without SSM layers)."""
        cfg, p = self.cfg, self.params
        tok = torch.where(fb, self.tok_buf[tok_slots], tok)
        tok_emb = torch.index_select(p["embed"]["tok"], 0, tok)
        x = torch.where(use[:, None], emb.to(tok_emb.dtype), tok_emb)
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
                    snap_conv_out=boundary[1][si], alora=al, adapter_idx=ad,
                    active_slots=act)
                x = x + y
                si += 1
                continue
            h = Lyr.rmsnorm(x, lp["ln1"], cfg.norm_eps)
            q, k, v = Lyr.qkv_project(lp["attn"], cfg, h, al, ad,
                                      active_slots=act)
            q = Lyr.apply_rope(q, pos, cfg.rope_theta)
            k = Lyr.apply_rope(k, pos, cfg.rope_theta)
            # padded rows all hit (dump_block, 0): duplicate indices, but
            # nothing reads the dump block within a valid q_len
            self.k_pool[ai].index_put_((wb, wo), k)
            self.v_pool[ai].index_put_((wb, wo), v)
            o = ragged_paged_attention(q, self.k_pool[ai], self.v_pool[ai],
                                       bt, rows, qln, window=self.window)
            x = x + Lyr.out_project(lp["attn"], cfg, o)
            x = M.mlp_sublayer(lp, cfg, x)
            ai += 1
        x = Lyr.rmsnorm(x, p["final_norm"], cfg.norm_eps)
        logits = M.logits_for(p, cfg, torch.index_select(x, 0, out_rows))
        sampled = torch.argmax(logits, dim=-1).to(torch.int32)
        # padded request rows all target the dump slot
        self.tok_buf.index_put_((run_slots,), sampled)
        return sampled, boundary

    @torch.no_grad()
    def submit_batch(self, mb: MixedBatch) -> StepHandle:
        """Enqueue one mixed step without waiting for it; retire the
        handle with :meth:`fetch_sampled`."""
        meta = self._assemble_mixed(mb)
        self.call_counts["mixed_step"] += 1
        sampled, boundary = self._mixed_impl(*meta)
        return StepHandle(sampled=sampled, n_requests=len(mb.block_tables),
                          boundary=boundary)

    def fetch_sampled(self, handle: StepHandle) -> np.ndarray:
        """Wait for ``handle``'s step and return its sampled ids (R,)
        int32 — the mixed path's only per-step device→host transfer."""
        ids = handle.sampled.cpu().numpy()
        log_d2h(self.d2h_fetches, int(ids.size), str(ids.dtype), "step",
                self.tracer)
        return ids[:handle.n_requests]

    def execute_batch(self, mb: MixedBatch) -> np.ndarray:
        """Synchronous submit + fetch; returns the sampled ids (R,)."""
        return self.fetch_sampled(self.submit_batch(mb))

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
