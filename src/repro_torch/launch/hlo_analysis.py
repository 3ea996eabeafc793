"""Roofline terms and collective accounting of the port's sharded steps,
the counterpart of the reference's ``repro/launch/hlo_analysis.py``.

The reference reads FLOPs and HBM bytes off XLA's ``cost_analysis`` and
its collectives off the compiled HLO text (``parse_collectives``).  The
port has no compiler to ask, so both come from the step's own shapes:

* :func:`step_collectives` lists every collective the port's step runs
  on one rank (``distributed.parallel``'s calls) from the configuration,
  the rank's ``RankLayout`` and the input shape; the CPU tests hold the list, kind by kind in counts and
  bytes, to ``parallel.COLLECTIVES`` counted on a real run at (2, 2);
* :func:`step_flops` counts the rank's matrix-product and attention
  operations (2 per multiply-add) from the same shapes;
* HBM bytes are the rank's argument and output bytes (a lower bound: the
  activations are not estimated, ``launch.dryrun``'s ``temp`` is null).

Roofline terms (NVIDIA H100 SXM, the data sheet's dense rates at the
700 W power limit):
  compute    = flops / 989e12 FLOP/s (bf16; float32 models 495e12 / 3,
               tensor-core 3xTF32)
  memory     = hbm_bytes / 3.35e12 B/s
  collective = wire_bytes / 450e9 B/s (NVLink, one direction)
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# NVIDIA H100 SXM (one card)
PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
PEAK_FLOPS_FP32 = 495e12 / 3  # float32 as 3xTF32 on the tensor cores
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 80e9             # device memory
NVLINK_BW = 450e9            # bytes/s, one direction

@dataclass
class CollectiveStats:
    # result bytes per collective kind on one rank
    by_kind: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    def total_result_bytes(self) -> int:
        return int(round(sum(self.by_kind.values())))

    def add(self, kind: str, nbytes: float, n: int = 1) -> None:
        self.by_kind[kind] = self.by_kind.get(kind, 0) + nbytes * n
        self.counts[kind] = self.counts.get(kind, 0) + n

    def wire_bytes(self, n_shards: int = 16) -> float:
        """Ring-algorithm wire-traffic estimate per rank."""
        f = (n_shards - 1) / max(n_shards, 1)
        w = 0.0
        for kind, b in self.by_kind.items():
            if kind == "all-reduce":
                w += 2 * f * b          # reduce-scatter + all-gather
            elif kind in ("all-gather", "reduce-scatter", "all-to-all"):
                w += f * b
            else:                        # collective-permute
                w += b
        return w


@dataclass
class Roofline:
    """Per-rank seconds of each term (flops, bytes and collectives are
    one rank's)."""
    flops: float
    hbm_bytes: float
    collective: CollectiveStats = field(default_factory=CollectiveStats)
    chips: int = 256
    model_flops: float = 0.0     # 6·N·D (train) or 2·N·D, GLOBAL
    peak_flops: float = PEAK_FLOPS

    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    def collective_s(self, n_shards: int = 16) -> float:
        return self.collective.wire_bytes(n_shards) / NVLINK_BW

    def dominant(self) -> str:
        terms = {"compute": self.compute_s(), "memory": self.memory_s(),
                 "collective": self.collective_s()}
        return max(terms, key=terms.get)

    def useful_flops_ratio(self) -> float:
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def summary(self) -> Dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_result_bytes":
                self.collective.total_result_bytes(),
            "collective_counts": dict(self.collective.counts),
            "compute_s": self.compute_s(),
            "memory_s": self.memory_s(),
            "collective_s": self.collective_s(),
            "dominant": self.dominant(),
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio(),
        }


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N_active·D for training, 2·N_active·D forward."""
    n = cfg.active_param_count()
    if shape.mode == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


# ---------------------------------------------------------------------------
# the port's collectives, from the shapes
# ---------------------------------------------------------------------------
def _sizes(mesh) -> Tuple[int, int]:
    """(data ranks the batch splits over, model ranks) of a mesh-like."""
    from repro_torch.distributed.sharding import axis_sizes
    sizes = axis_sizes(mesh)
    ds = math.prod(int(v) for k, v in sizes.items() if k != "model")
    return ds, int(sizes.get("model", 1))


def _elt(cfg) -> int:
    return 2 if cfg.dtype in ("bfloat16", "float16") else 4


def step_collectives(cfg, mode: str, batch: int, seq: int, mesh, rt,
                     loss_chunk: int = 512) -> List[Tuple[str, str, int]]:
    """Every collective one rank of the port's ``mode`` step runs
    ("prefill": ``forward_full`` and the last position's logits;
    "decode": one ``decode_step``; "train": ``make_train_step``'s step),
    as ``(kind, axis, result bytes)``.
    ``batch`` and ``seq`` are the global input shape; ``rt`` the step's
    ``Runtime`` (its ``mesh`` a mapping or a live mesh).  The backward's
    collectives follow the forward's in reverse layer order, each layer's
    in no particular order."""
    from repro_torch.configs.base import SSM
    from repro_torch.distributed.sharding import rank_layout
    from repro_torch.models.layers import padded_vocab
    from repro_torch.models.model import param_specs
    ds, ms = _sizes(mesh)
    lay = rank_layout(cfg, ms, 0)
    e = _elt(cfg)
    d, V = cfg.d_model, padded_vocab(cfg)
    sharded = ds > 1 and batch % ds == 0
    B = batch // ds if sharded else batch
    out: List[Tuple[str, str, int]] = []

    def ar(axis, nbytes, when=True):
        if when and (ds if axis == "data" else ms) > 1:
            out.append(("all-reduce", axis, int(nbytes)))

    def ag(axis, nbytes, when=True):
        if when and (ds if axis == "data" else ms) > 1:
            out.append(("all-gather", axis, int(nbytes)))

    if rt.context_parallel:
        return _cp_collectives(cfg, mode, B, seq, ds, ms, e)
    S = 1 if mode == "decode" else seq
    S_text = S
    if cfg.frontend == "vision" and mode != "decode":
        S = S + cfg.num_patches
    ep = rt.moe_impl == "expert_parallel"
    aux = mode != "decode"           # forward_full computes the aux

    def layer_forward(kind, enc=False, L=S):
        t = B * L
        if kind == SSM:
            ar("model", t * 4, lay.ssm)             # gated norm sum
            ar("model", t * d * 4, lay.ssm)         # out_proj
            return
        ar("model", t * d * e, lay.attn)            # Wo
        if cfg.is_encoder_decoder and not enc:
            ar("model", t * d * e, lay.attn)        # cross-attention Wo
        if cfg.moe is None:
            ar("model", t * d * e, lay.mlp)
            return
        E = cfg.moe.num_experts
        if ep:
            ar("data", 4, aux and sharded)          # aux pmean
            ar("model", t * d * e, lay.moe)
        else:
            ar("data", E * 4, aux and sharded)      # p_e over data
            ar("data", E * 4, aux and sharded)      # f_e over data
            ar("model", t * d * e, lay.moe)

    def layer_backward(kind, enc=False, L=S):
        t = B * L
        if kind == SSM:
            ar("model", t * 4, lay.ssm)             # the norm sum's
            ar("model", t * d * e, lay.ssm)         # f before in_proj
            return
        if cfg.moe is not None:
            if ep:
                ar("model", t * d * e, lay.moe)     # experts' input
                ar("model", t * cfg.moe.experts_per_token * 4, lay.moe)
            else:
                ar("model", t * d * e, lay.moe)
                ar("model", t * cfg.moe.num_experts * e, lay.moe)
        else:
            ar("model", t * d * e, lay.mlp)
        if cfg.is_encoder_decoder and not enc:
            ar("model", B * cfg.encoder_seq_len * d * e, lay.attn)  # enc K/V
            ar("model", t * d * e, lay.attn)        # cross-attention q
        ar("model", t * d * e, lay.attn)            # f before Q/K/V

    # forward
    ar("model", B * S_text * d * e, lay.vocab)      # vocab-parallel embed
    if cfg.is_encoder_decoder and mode != "decode":
        for _ in range(cfg.num_encoder_layers):
            layer_forward("attn", enc=True, L=cfg.encoder_seq_len)
    kinds = cfg.pattern()
    for kind in kinds:
        layer_forward(kind)
    if mode == "prefill":
        ag("model", B * V * e, lay.vocab)
    elif mode == "decode":
        ag("model", B * V * e, lay.vocab)
    else:
        nch = max(S_text // min(loss_chunk, S_text), 1)
        ch = S_text // nch
        for _ in range(nch):
            ag("model", B * ch * V * e, lay.vocab)
        ar("data", 4, sharded)                      # the mask count
        # backward: logits' f, then the layers in reverse (remat runs
        # each layer's forward again first)
        for _ in range(nch):
            ar("model", B * ch * d * e, lay.vocab)
        for kind in reversed(kinds):
            if rt.remat:
                # the layer's forward again, up to its last saved tensor
                # (``torch.utils.checkpoint`` stops early): all but its
                # last collective, the row-parallel sum into the residual
                n = len(out)
                layer_forward(kind)
                if len(out) > n:
                    out.pop()
            layer_backward(kind)
        if cfg.is_encoder_decoder:                  # not rematerialised
            for _ in range(cfg.num_encoder_layers):
                layer_backward("attn", enc=True, L=cfg.encoder_seq_len)
        ar("data", 4, sharded)                      # the loss
        out.extend(_optimizer_collectives(cfg, lay, param_specs(cfg), ds,
                                          ms, sharded, mesh))
    return out


def _optimizer_collectives(cfg, lay, specs, ds, ms, sum_data, mesh):
    from repro_torch.common import tree_paths
    from repro_torch.distributed.sharding import zero1_local_dims
    out = []
    leaves = [(path, lay.local_shape(path, tuple(t.shape)), t)
              for path, t in tree_paths(specs)]
    n = sum(math.prod(s) for _, s, _ in leaves)
    if sum_data and ds > 1:
        out.append(("all-reduce", "data", n * 4))
    if ms > 1:
        # leaves some of whose elements several model ranks hold
        # (``optimizer.copies``: the ranks' equal slices overlap), summed
        # at full width
        shared = 0
        for path, s, t in leaves:
            pl = lay.plan(path, tuple(t.shape))
            if pl is not None and len(pl[1]) * ms > pl[2]:
                shared += math.prod(s) // s[pl[0]] * pl[2]
        if shared:
            out.append(("all-reduce", "model", shared * 4))
        out.append(("all-reduce", "model", 4))      # the norm
    if ds > 1:
        dims = zero1_local_dims(cfg, specs, mesh, lay)
        by_dtype: Dict = {}
        for path, s, t in leaves:
            if dims[path] is not None:
                by_dtype[t.dtype] = by_dtype.get(t.dtype, 0) \
                    + math.prod(s) * t.element_size()
        for nbytes in by_dtype.values():
            out.append(("all-gather", "data", nbytes))
    return out


def _cp_collectives(cfg, mode, B, seq, ds, ms, e):
    """The context-parallel prefill: each layer's FSDP-sharded weights
    gathered over ``data``, its K/V over ``model``; the embedding and
    the unembedding gathered."""
    from repro_torch.distributed.sharding import (_paths,
                                                  fsdp_param_specs_tree)
    from repro_torch.models.model import param_specs
    if mode != "prefill":
        raise ValueError("context parallelism serves the prefill")
    specs = param_specs(cfg)
    fs = dict(_paths(fsdp_param_specs_tree(cfg, specs, {"data": ds})))
    full = dict(_paths(specs))
    out = []

    def gather(path):
        t = full[path]
        if ds > 1 and fs[path] and fs[path][0] == "data":
            out.append(("all-gather", "data",
                        math.prod(t.shape) * t.element_size()))
    gather(("embed", "tok"))
    kv = B * seq * cfg.num_kv_heads * cfg.head_dim * e
    for i, _ in enumerate(cfg.pattern()):
        for p in full:
            if p[:2] == ("layers", i):
                gather(p)
        if ms > 1:
            out += [("all-gather", "model", kv)] * 2
    if ms > 1:                  # the last position's row, from its rank
        out.append(("all-gather", "model", ms * B * cfg.d_model * e))
    for p in full:
        if p[0] == "embed":
            gather(p)
    return out


def collective_stats(entries) -> CollectiveStats:
    stats = CollectiveStats()
    for kind, _, nbytes in entries:
        stats.add(kind, nbytes)
    return stats


# ---------------------------------------------------------------------------
# the rank's operations, from the shapes
# ---------------------------------------------------------------------------
def step_flops(cfg, mode: str, batch: int, seq: int, mesh, rt,
               window: int = 0) -> float:
    """One rank's operations (2 per multiply-add) in the step's matrix
    products and attention: every weight the rank holds against the
    rank's tokens (the unembedding at the last position only in a
    prefill; an expert-parallel layer's experts at their capacity),
    attention's QKᵀ and PV over the causal (windowed) context;
    training counts the backward as twice the forward, and a
    rematerialised forward once more."""
    from repro_torch.common import tree_paths
    from repro_torch.configs.base import SSM
    from repro_torch.distributed.sharding import rank_layout
    from repro_torch.models.layers import padded_vocab
    from repro_torch.models.model import param_specs
    ds, ms = _sizes(mesh)
    B = batch // ds if ds > 1 and batch % ds == 0 else batch
    lay = rank_layout(cfg, ms, 0)
    if rt.context_parallel:
        lay = rank_layout(cfg, 1, 0)
    S = 1 if mode == "decode" else seq
    if cfg.frontend == "vision" and mode != "decode":
        S += cfg.num_patches
    T = B * S // (ms if rt.context_parallel else 1)
    f = 0.0
    for path, t in tree_paths(param_specs(cfg)):
        if path[0] != "layers" or len(t.shape) < 2 or \
                str(path[-1]) in ("conv_w", "router"):
            continue
        n = math.prod(lay.local_shape(path, tuple(t.shape)))
        if len(t.shape) == 3 and rt.moe_impl == "expert_parallel":
            # each local expert runs its capacity of slots
            m = cfg.moe
            f += 2.0 * n * math.ceil(T * m.experts_per_token
                                     / m.num_experts * rt.capacity_factor)
            continue
        f += 2.0 * n * T                    # masked dense: every row
    H = len(lay.q_heads)
    ctx = seq if mode == "decode" else S
    w = window or cfg.sliding_window
    for kind in cfg.pattern():
        if kind == SSM:
            continue
        if mode == "decode":
            span = min(ctx, w) if w else ctx
            f += 4.0 * B * H * cfg.head_dim * span
        else:
            span = (min(S, w) if w else S / 2)
            f += 4.0 * T * H * cfg.head_dim * span
    V = padded_vocab(cfg) // (ms if lay.vocab else 1)
    f += 2.0 * cfg.d_model * V * (B * S if mode == "train" else B)
    if mode == "train":
        f *= 4.0 if rt.remat else 3.0
    return f
