"""Sharding rules of the port: the reference's ``repro/distributed/
sharding.py`` as shape arithmetic over a plain partition-spec type, and
the per-rank layout the sharded mixed step runs on.

Part 1, the rules (letter for letter the reference's, over the port's
trees).  Megatron-style tensor parallelism over ``model``, data
parallelism over ``pod`` + ``data``: Wq/Wk/Wv column-parallel, Wo
row-parallel; MLP up/gate column-parallel, down row-parallel; MoE
experts on ``model``; the split SSM input projections column-parallel
and out_proj row-parallel; the (512-padded) vocab on ``model``; K/V
caches on KV heads when both head counts divide the model axis, else on
``head_dim``; optimizer moments on the parameter specs plus ZeRO-1 over
``data``.  Every function takes a ``DeviceMesh`` or an ``{axis: size}``
mapping.  The port's parameters and decode caches are one dict per
layer in network order, so their specs drop the reference's two
``(repeats, count)`` stacking dims; adapter trees keep the reference's
segment stacking, and so do their specs.

Part 2, the layout the port runs (``RankLayout``).  ``jax.shard_map`` and
``to_named`` have no counterpart here: :func:`shard_tensor` turns a full
tensor and its spec into one rank's slice and :func:`gather_tensor`
puts the slices back.  The mixed step runs its hand-written kernels on
each rank's slice, so where a rule above would split what a kernel
needs whole, the layout diverges from the spec (ROADMAP, deliberate
divergences):

* attention: each rank holds H/ms query heads and the K/V heads those
  heads read, a K/V head replicated on every rank whose queries read it
  when KV < ms (vLLM's rule), never a ``head_dim`` split (the paged
  attention kernel would need its QKᵀ partial sums reduced across ranks
  before the softmax).  Where H does not divide the model axis, or the
  query groups straddle ranks, attention stays whole on every rank;
* SSM: a head-aligned split.  Each rank takes the x channels of its
  nh/ms heads and the B/C channels of their groups whole (the
  reference splits the fused ``in_xbc`` output and the conv pool
  contiguously), so the ragged scan runs on whole heads per rank; the
  gated norm reduces its sum of squares across ranks.

:func:`shard_params` keeps one rank's slice of each leaf and moves it to
the device leaf by leaf (a leaf already this rank's slice is kept as it
is), :func:`gather_params` inverts it, and :func:`shard_adapter_layers`
slices adapter B matrices (and slot stacks) on their output columns.
"""
from __future__ import annotations

import functools
import itertools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import SSM, ModelConfig
from repro_torch.models.layers import padded_vocab
from repro_torch.models.ssm import in_proj_dim, ssm_dims

Tree = Any


class P(tuple):
    """A partition spec: one entry per array dim, each ``None``
    (replicated), a mesh axis name, or a tuple of axis names (sharded
    over their product).  Trailing dims left out are replicated."""

    def __new__(cls, *dims):
        # a one-axis tuple is that axis (as jax's PartitionSpec has it)
        return super().__new__(cls, (d[0] if isinstance(d, tuple)
                                     and len(d) == 1 else d for d in dims))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


# mesh-shaped things: a DeviceMesh, or a {axis: size} mapping (the spec
# tests probe mesh shapes far larger than any host)
MeshLike = Union[Mapping[str, int], Any]


def axis_sizes(mesh: MeshLike) -> Mapping[str, int]:
    if isinstance(mesh, Mapping):
        return mesh
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _shards_of(axes, sizes: Mapping[str, int]) -> int:
    names = axes if isinstance(axes, tuple) else (axes,)
    n = 1
    for a in names:
        n *= int(sizes[a])
    return n


def fit_spec(spec: P, shape: Tuple[int, ...], mesh: MeshLike) -> P:
    """Drop (to replicated) every spec dim whose axis product does not
    divide the corresponding array dim: the guarantee that makes every
    spec tree valid on every mesh."""
    sizes = axis_sizes(mesh)
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = [ax if ax is not None and d % _shards_of(ax, sizes) == 0
           else None
           for d, ax in zip(shape, dims)]
    return P(*out)


# ---------------------------------------------------------------------------
# trees: nested dicts/lists whose leaves carry a ``.shape``
# ---------------------------------------------------------------------------
def _is_container(t) -> bool:
    return type(t) in (dict, list, tuple)


def _paths(tree, prefix: tuple = ()) -> List[Tuple[tuple, Any]]:
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in _paths(v, prefix + (k,))]
    if _is_container(tree):
        return [pl for i, v in enumerate(tree)
                for pl in _paths(v, prefix + (i,))]
    return [(prefix, tree)]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if _is_container(t):
            return type(t)(go(v) for v in t)
        return next(it)
    return go(tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape)


# ---------------------------------------------------------------------------
# part 1: the reference's rules
# ---------------------------------------------------------------------------
def _leaf_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
               cfg: ModelConfig, model: str, n_lead: int) -> P:
    """Spec for one parameter leaf.  ``n_lead`` = stacking dims (layer
    repeats/count, adapter index) prepended as None."""
    name = path[-1]
    lead = (None,) * n_lead
    core = len(shape) - n_lead

    def spec(*dims):
        if len(dims) != core:
            raise ValueError(f"{path}: shape {shape} against spec {dims}")
        return P(*(lead + dims))

    if name in ("tok",):
        return P(model, None)
    if name in ("unembed",):
        return P(None, model)
    if name in ("wq", "wk", "wv", "w_up", "w_gate",
                "in_z", "in_xbc", "in_dt"):
        if core == 3:                       # MoE expert stacks (E, d, ff)
            return spec(model, None, None)
        return spec(None, model)
    if name in ("wo", "w_down", "out_proj"):
        if core == 3:                       # MoE (E, ff, d)
            return spec(model, None, None)
        return spec(model, None)
    if name in ("aq", "ak", "av", "a"):     # adapter A: (d, r)
        return spec(None, None)
    if name in ("bq", "bk", "bv"):          # adapter B: (r, out)
        return spec(None, model)
    if name == "b":                         # ssm adapter B
        return spec(None, model)
    # everything else (norms, router, conv, A_log, dt_bias, D, biases)
    return P(*((None,) * len(shape)))


def _n_lead_dims(path) -> int:
    """Segment-stacked leaves (adapter trees: ``seg{i}``) carry (repeats,
    count) stacking; the port's per-layer parameters carry none."""
    keys = [str(k) for k in path]
    if any(k.startswith("seg") for k in keys) or "blocks" in keys:
        return 2
    return 0


def param_specs_tree(cfg: ModelConfig, params_shape: Tree,
                     model_axis: str = "model", extra_lead: int = 0,
                     mesh: Optional[MeshLike] = None) -> Tree:
    """Spec tree matching ``params_shape`` (any tree of leaves with a
    ``.shape``).  ``extra_lead`` adds leading dims (the stacked-adapter
    axis).  With ``mesh``, a dim that does not divide falls back to
    replicated (:func:`fit_spec`)."""
    specs = []
    for path, leaf in _paths(params_shape):
        shape = _shape(leaf)
        n_lead = _n_lead_dims(path) + extra_lead
        names = tuple(str(k) for k in path)
        s = _leaf_spec(names, shape, cfg, model_axis, min(n_lead, len(shape)))
        if mesh is not None:
            s = fit_spec(s, shape, mesh)
        specs.append(s)
    return _rebuild(params_shape, specs)


def fsdp_param_specs_tree(cfg: ModelConfig, params_shape: Tree,
                          mesh: MeshLike, data_axis: str = "data") -> Tree:
    """Context-parallel / FSDP weight layout: every matrix shards its
    first core dim over ``data``; nothing lives on ``model``."""
    ds = axis_sizes(mesh)[data_axis]
    specs = []
    for path, leaf in _paths(params_shape):
        shape = _shape(leaf)
        n_lead = min(_n_lead_dims(path), len(shape))
        core = shape[n_lead:]
        dims: List[Any] = [None] * len(shape)
        if len(core) >= 2 and core[0] % ds == 0 and core[0] >= ds:
            dims[n_lead] = data_axis
        specs.append(P(*dims))
    return _rebuild(params_shape, specs)


def adapter_specs_tree(cfg: ModelConfig, ad_shape: Tree,
                       model_axis: str = "model",
                       mesh: Optional[MeshLike] = None) -> Tree:
    """Adapter stacks: leaves are (repeats, count, n_adapters, ...)."""
    return param_specs_tree(cfg, ad_shape, model_axis, extra_lead=1,
                            mesh=mesh)


def adapter_slot_specs(cfg: ModelConfig, layer_shape: Tree,
                       mesh: Optional[MeshLike] = None,
                       model_axis: str = "model") -> Tree:
    """Specs for ONE layer's adapter slot stack (``AdapterPool.layers``
    entries): A ``(S+1, d, r)`` replicated, B ``(S+1, r, out)``
    column-parallel on ``out``."""
    return param_specs_tree(cfg, layer_shape, model_axis, extra_lead=1,
                            mesh=mesh)


def batch_specs(batch_axes: Tuple[str, ...]) -> Dict[str, P]:
    return {
        "tokens": P(batch_axes, None),
        "labels": P(batch_axes, None),
        "mask": P(batch_axes, None),
        "extra_embeds": P(batch_axes, None, None),
    }


def _kv_on_heads(cfg: ModelConfig, ms: int) -> bool:
    """The heads-vs-head_dim rule every K/V spec shares: the KV-head dim
    only when BOTH q and kv head counts divide the model axis."""
    return cfg.num_kv_heads % ms == 0 and cfg.num_heads % ms == 0


def kv_cache_spec(cfg: ModelConfig, batch_axes, model_axis: str,
                  batch_shardable: bool = True,
                  mesh: Optional[MeshLike] = None) -> P:
    """One layer's dense cache (B, S, KV, hd): heads when both head
    counts divide the model axis, else head_dim.  Without a mesh,
    assumes the production 16-way model axis."""
    b = batch_axes if batch_shardable else None
    ms = 16 if mesh is None else axis_sizes(mesh)[model_axis]
    if _kv_on_heads(cfg, ms):
        return P(b, None, model_axis, None)
    return P(b, None, None, model_axis if cfg.head_dim % ms == 0 else None)


def cache_specs_tree(cfg: ModelConfig, caches_shape: Tree, mesh: MeshLike,
                     batch_axes: Tuple[str, ...], model_axis: str = "model",
                     batch_shardable: bool = True) -> Tree:
    """Specs for the per-layer decode caches of
    ``models.model.init_decode_caches``."""
    ms = axis_sizes(mesh)[model_axis]
    b = batch_axes if batch_shardable else None

    def leaf(path, s) -> P:
        name = str(path[-1])
        shape = _shape(s)
        if name in ("k", "v", "xk", "xv"):                 # (B, S, KV, hd)
            if _kv_on_heads(cfg, ms):
                return P(b, None, model_axis, None)
            if cfg.head_dim % ms:
                raise ValueError(f"{cfg.name}: head_dim {cfg.head_dim} "
                                 f"does not divide the model axis {ms}")
            return P(b, None, None, model_axis)
        if name in ("ks", "vs"):                           # (B, S, KV)
            if _kv_on_heads(cfg, ms):
                return P(b, None, model_axis)
            return P(b, None, None)
        if name == "ssm":                                  # (B, nh, N, P)
            return P(b, model_axis if shape[1] % ms == 0 else None, None,
                     None)
        if name == "conv":                                 # (B, W-1, ch)
            return P(b, None, model_axis if shape[2] % ms == 0 else None)
        return P(*((None,) * len(shape)))

    return _rebuild(caches_shape, [leaf(p, s) for p, s in _paths(caches_shape)])


@dataclass(frozen=True)
class StepShardings:
    """Layouts of the serving pools over ``mesh`` (the reference's, for
    the record: :class:`RankLayout` is what the port runs).  ``None``
    state specs mean the arch has no SSM pools."""
    mesh: Any
    kv_pool: P                       # (La, NB, bs, KV, hd)
    ssm_pool: Optional[P] = None     # (Ls, slots, nh, N, P)
    conv_pool: Optional[P] = None    # (Ls, slots, W-1, ch)
    attn_out: Optional[P] = None     # (T, H, hd)
    tok_buf: P = P()                 # (MR,) and the (Rb,) sampled ids
    tok_meta: P = P()                # (Tb,) per-token rows
    tok_embeds: P = P()              # (Tb, d)
    replicated: P = P()


def mixed_step_shardings(cfg: ModelConfig, mesh: MeshLike,
                         model_axis: str = "model",
                         data_axis: Optional[str] = None) -> StepShardings:
    """The reference's layouts of the paged serving pools; ``data_axis``
    (present with size > 1) also splits the packed token axis."""
    sizes = axis_sizes(mesh)
    ms = sizes[model_axis]
    tok_ax = data_axis if data_axis is not None \
        and sizes.get(data_axis, 1) > 1 else None
    if _kv_on_heads(cfg, ms):
        kv = P(None, None, None, model_axis, None)
        attn_out = P(tok_ax, model_axis, None)
    else:
        hd_ax = model_axis if cfg.head_dim % ms == 0 else None
        kv = P(None, None, None, None, hd_ax)
        attn_out = P(tok_ax, None, hd_ax)
    ssm_pool = conv_pool = None
    if SSM in cfg.pattern():
        _, nh, ch = ssm_dims(cfg)
        ssm_pool = P(None, None, model_axis if nh % ms == 0 else None,
                     None, None)
        conv_pool = P(None, None, None, model_axis if ch % ms == 0 else None)
    return StepShardings(mesh=mesh, kv_pool=kv, ssm_pool=ssm_pool,
                         conv_pool=conv_pool, attn_out=attn_out,
                         tok_meta=P(tok_ax), tok_embeds=P(tok_ax, None))


def zero1_specs(param_spec_tree: Tree, params_shape: Tree, mesh: MeshLike,
                data_axis: str = "data") -> Tree:
    """ZeRO-1: shard optimizer moments over ``data`` on the first dim
    that is unsharded and divisible."""
    ds = axis_sizes(mesh)[data_axis]
    specs = [s for _, s in _paths(param_spec_tree)]
    shapes = [_shape(s) for _, s in _paths(params_shape)]
    if len(specs) != len(shapes):
        raise ValueError("spec and shape trees differ")

    def leaf(spec: P, shape) -> P:
        dims = list(spec) + [None] * (len(shape) - len(spec))
        for i, (d, cur) in enumerate(zip(shape, dims)):
            if cur is None and d % ds == 0 and d >= ds:
                dims[i] = data_axis
                return P(*dims)
        return spec

    return _rebuild(param_spec_tree,
                    [leaf(sp, sh) for sp, sh in zip(specs, shapes)])


# ---------------------------------------------------------------------------
# spec <-> slices
# ---------------------------------------------------------------------------
def _block(ax, sizes: Mapping[str, int], coords: Mapping[str, int]
           ) -> Tuple[int, int]:
    """(index, count) of this coordinate's block along a dim sharded
    over ``ax`` (axes in order, row-major)."""
    names = ax if isinstance(ax, tuple) else (ax,)
    i = 0
    for a in names:
        i = i * int(sizes[a]) + int(coords[a])
    return i, _shards_of(ax, sizes)


def shard_tensor(x: torch.Tensor, spec: P, mesh: MeshLike,
                 coords: Mapping[str, int]) -> torch.Tensor:
    """This rank's slice of the full tensor ``x`` under ``spec``: a
    contiguous block of every sharded dim (a copy, so the full tensor
    can be freed)."""
    sizes = axis_sizes(mesh)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        i, n = _block(ax, sizes, coords)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"divide {n} shards ({spec})")
        step = x.shape[dim] // n
        x = x.narrow(dim, i * step, step)
    return x.clone()


def all_coords(mesh: MeshLike) -> List[Dict[str, int]]:
    """Every coordinate of the mesh, row-major."""
    sizes = axis_sizes(mesh)
    names = list(sizes)
    return [dict(zip(names, c))
            for c in itertools.product(*(range(sizes[a]) for a in names))]


def gather_tensor(shards: Sequence[torch.Tensor], spec: P,
                  mesh: MeshLike) -> torch.Tensor:
    """The inverse of :func:`shard_tensor`: ``shards`` holds one slice per
    coordinate, in :func:`all_coords` order."""
    sizes = axis_sizes(mesh)
    coords = all_coords(mesh)
    if len(shards) != len(coords):
        raise ValueError(f"{len(shards)} shards for {len(coords)} ranks")
    shape = list(shards[0].shape)
    for dim, ax in enumerate(spec):
        if ax is not None:
            shape[dim] *= _shards_of(ax, sizes)
    out = shards[0].new_empty(shape)
    for c, s in zip(coords, shards):
        idx = []
        for dim in range(len(shape)):
            ax = spec[dim] if dim < len(spec) else None
            if ax is None:
                idx.append(slice(None))
                continue
            i, _ = _block(ax, sizes, c)
            idx.append(slice(i * s.shape[dim], (i + 1) * s.shape[dim]))
        out[tuple(idx)] = s
    return out


# ---------------------------------------------------------------------------
# part 2: the layout the port runs
# ---------------------------------------------------------------------------
def _span(units: range, width: int) -> List[int]:
    """Channel indices of ``units`` consecutive blocks of ``width``."""
    return list(range(units.start * width, units.stop * width))


def _groups_of(heads: range, per_group: int) -> Optional[range]:
    """The groups ``heads`` read when ``per_group`` consecutive heads
    share one; None when the heads straddle groups unevenly (a rank would
    hold part of a group and part of another)."""
    n = len(heads)
    if n % per_group and per_group % n:
        return None
    return range(heads.start // per_group,
                 (heads.stop - 1) // per_group + 1)


@dataclass(frozen=True)
class RankLayout:
    """What one model-axis rank holds of every weight, pool and adapter.

    ``q_heads``/``kv_heads``: the attention heads this rank computes
    (every head where attention stays whole); ``attn``/``mlp``/``moe``/
    ``ssm``/``vocab``: whether that part is split (and so needs its
    row-parallel sum or its vocab gather).  ``ff``, ``experts``,
    ``ssm_heads``, ``ssm_groups``, ``vocab_rows``: this rank's ranges."""
    cfg: ModelConfig
    ms: int
    mr: int
    q_heads: range
    kv_heads: range
    ff: range
    experts: range
    ssm_heads: range
    ssm_groups: range
    vocab_rows: range
    attn: bool
    mlp: bool
    moe: bool
    ssm: bool
    vocab: bool

    # -- the index plan of each leaf (built once a layout) --------------
    @functools.cached_property
    def _qkv(self):
        hd = self.cfg.head_dim
        return _span(self.q_heads, hd), _span(self.kv_heads, hd)

    @functools.cached_property
    def _ssm_index(self):
        """(x channels of the local heads, conv channels, local heads,
        the fused [z | xBC | dt] columns) of the local SSM heads."""
        s = self.cfg.ssm
        d_inner, nh, ch = ssm_dims(self.cfg)
        P_, N = s.head_dim, s.state_dim
        x = _span(self.ssm_heads, P_)
        g = self.ssm_groups
        xbc = x + [d_inner + c for c in _span(g, N)] \
            + [d_inner + s.ngroups * N + c for c in _span(g, N)]
        heads = list(self.ssm_heads)
        fused = x + [d_inner + c for c in xbc] \
            + [d_inner + ch + h for h in heads]
        return x, xbc, heads, fused

    def plan(self, path: Tuple, shape: Tuple[int, ...]
             ) -> Optional[Tuple[int, List[int], int]]:
        """``(dim, indices, full length)`` of the leaf at ``path``, or None
        where every rank holds it whole."""
        name = str(path[-1])
        cfg = self.cfg
        if self.vocab and name == "tok":
            return 0, list(self.vocab_rows), padded_vocab(cfg)
        if self.vocab and name == "unembed":
            return 1, list(self.vocab_rows), padded_vocab(cfg)
        if len(shape) == 3 and name in ("w_up", "w_gate", "w_down"):
            return (0, list(self.experts), cfg.moe.num_experts) \
                if self.moe else None
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        if self.attn and name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
            q, kv = self._qkv
            if name in ("wq", "bq"):
                return (1 if name == "wq" else -1), q, H * hd
            if name == "wo":
                return 0, q, H * hd
            return (1 if name[0] == "w" else -1), kv, KV * hd
        if self.mlp and name in ("w_up", "w_gate"):
            return 1, list(self.ff), cfg.d_ff
        if self.mlp and name == "w_down":
            return 0, list(self.ff), cfg.d_ff
        if self.ssm and name in _SSM_LEAVES:
            d_inner, nh, ch = ssm_dims(cfg)
            x, xbc, heads, fused = self._ssm_index
            dim, idx, full = {
                "in_z": (1, x, d_inner), "in_xbc": (1, xbc, ch),
                "in_dt": (1, heads, nh), "conv_w": (1, xbc, ch),
                "conv_b": (0, xbc, ch), "A_log": (0, heads, nh),
                "dt_bias": (0, heads, nh), "D": (0, heads, nh),
                "norm_w": (0, x, d_inner), "out_proj": (0, x, d_inner),
                "b": (-1, fused, in_proj_dim(cfg))}[name]
            return dim, idx, full
        return None

    def take(self, path: Tuple, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the leaf ``t`` at ``path`` (``t`` itself
        when the rank holds it whole, or when ``t`` already is the
        slice)."""
        pl = self.plan(path, tuple(t.shape))
        if pl is None:
            return t
        dim, idx, full = pl
        n = t.shape[dim]
        if n == len(idx):
            return t
        if n != full:
            raise ValueError(f"{'/'.join(map(str, path))}: dim {dim} of "
                             f"{tuple(t.shape)} is neither {full} nor "
                             f"this rank's {len(idx)}")
        return t.index_select(dim, torch.tensor(idx, device=t.device))

    def local_shape(self, path: Tuple, shape: Tuple[int, ...]
                    ) -> Tuple[int, ...]:
        pl = self.plan(path, shape)
        if pl is None:
            return tuple(shape)
        out = list(shape)
        out[pl[0]] = len(pl[1])
        return tuple(out)

    # -- the local widths -------------------------------------------------
    @property
    def local_cfg(self) -> ModelConfig:
        """The configuration the rank's attention reshapes by: its own
        query and K/V head counts."""
        return self.cfg.replace(num_heads=len(self.q_heads),
                                num_kv_heads=len(self.kv_heads))

    def ssm_local_dims(self) -> Tuple[int, int, int]:
        """(d_inner, heads, conv channels) of the rank's SSM slice."""
        s = self.cfg.ssm
        nh = len(self.ssm_heads)
        return (nh * s.head_dim, nh,
                nh * s.head_dim + 2 * len(self.ssm_groups) * s.state_dim)

    @property
    def d_inner(self) -> int:
        return ssm_dims(self.cfg)[0]


_SSM_LEAVES = ("in_z", "in_xbc", "in_dt", "conv_w", "conv_b", "A_log",
               "dt_bias", "D", "norm_w", "out_proj", "b")


def rank_layout(cfg: ModelConfig, ms: int, mr: int) -> RankLayout:
    """The layout of model-axis rank ``mr`` of ``ms``."""
    if not 0 <= mr < ms:
        raise ValueError(f"model rank {mr} outside 0..{ms - 1}")
    whole = lambda n: range(n)  # noqa: E731

    def split(n: int) -> Tuple[bool, range]:
        if ms > 1 and n % ms == 0:
            k = n // ms
            return True, range(mr * k, (mr + 1) * k)
        return False, whole(n)

    H, KV = cfg.num_heads, cfg.num_kv_heads
    attn, q_heads = split(H)
    kv_heads = _groups_of(q_heads, H // KV) if attn else None
    if kv_heads is None:
        attn, q_heads, kv_heads = False, whole(H), whole(KV)
    mlp, ff = split(cfg.d_ff) if cfg.moe is None else (False, whole(0))
    moe, experts = split(cfg.moe.num_experts) if cfg.moe is not None \
        else (False, whole(0))
    ssm = False
    ssm_heads = ssm_groups = whole(0)
    if cfg.ssm is not None:
        _, nh, _ = ssm_dims(cfg)
        ssm, ssm_heads = split(nh)
        ssm_groups = _groups_of(ssm_heads, nh // cfg.ssm.ngroups) \
            if ssm else None
        if ssm_groups is None:
            ssm, ssm_heads, ssm_groups = False, whole(nh), \
                whole(cfg.ssm.ngroups)
    vocab, vocab_rows = split(padded_vocab(cfg))
    return RankLayout(cfg=cfg, ms=ms, mr=mr, q_heads=q_heads,
                      kv_heads=kv_heads, ff=ff, experts=experts,
                      ssm_heads=ssm_heads, ssm_groups=ssm_groups,
                      vocab_rows=vocab_rows, attn=attn, mlp=mlp, moe=moe,
                      ssm=ssm, vocab=vocab)


def _layout_of(cfg: ModelConfig, mesh: MeshLike,
               coords: Mapping[str, int]) -> RankLayout:
    return rank_layout(cfg, int(axis_sizes(mesh).get("model", 1)),
                       int(coords.get("model", 0)))


def layout_of(cfg: ModelConfig, mesh) -> RankLayout:
    """This process's layout on ``mesh`` (a ``DeviceMesh`` it is a rank
    of)."""
    from repro_torch.launch.mesh import mesh_coords
    return _layout_of(cfg, mesh, mesh_coords(mesh))


def shard_tree(tree: Tree, layout: RankLayout, device=None) -> Tree:
    """Every leaf of ``tree`` cut to ``layout``'s slice, then moved to
    ``device`` (None: left where it is), one leaf at a time."""
    out = []
    for path, t in _paths(tree):
        t = layout.take(path, t)
        out.append(t if device is None else t.to(device))
    return _rebuild(tree, out)


def shard_params(params: Tree, cfg: ModelConfig, mesh: MeshLike,
                 coords: Mapping[str, int], device=None) -> Tree:
    """The rank at ``coords``'s slice of the port's parameters (the full
    tree of ``models.model.init_params`` or ``convert.params_from_jax``),
    each leaf cut before it moves to ``device``.  Parameters are
    replicated over ``data``."""
    return shard_tree(params, _layout_of(cfg, mesh, coords), device)


def shard_adapter_layers(layers: Tree, cfg: ModelConfig, mesh: MeshLike,
                         coords: Mapping[str, int], device=None) -> Tree:
    """Per-layer adapter weights (or slot stacks: any leading dims) cut
    to the rank's output columns of each B; A stays whole."""
    return shard_tree(layers, _layout_of(cfg, mesh, coords), device)


def gather_params(shards: Sequence[Tree], cfg: ModelConfig,
                  ms: int) -> Tree:
    """The inverse of :func:`shard_params` over the model axis:
    ``shards[r]`` is model rank ``r``'s tree.  A leaf replicated on
    several ranks (a shared K/V head, a whole part) is written by each
    with the same values."""
    layouts = [rank_layout(cfg, ms, r) for r in range(ms)]
    flat = [_paths(s) for s in shards]
    out = []
    for i, (path, t0) in enumerate(flat[0]):
        pl = layouts[0].plan(path, tuple(t0.shape))
        if pl is None:
            out.append(t0.clone())
            continue
        dim, _, full = pl
        shape = list(t0.shape)
        shape[dim] = full
        whole = t0.new_empty(shape)
        for lay, f in zip(layouts, flat):
            _, idx, _ = lay.plan(path, tuple(t0.shape))
            whole.index_copy_(dim % len(shape),
                              torch.tensor(idx, device=t0.device), f[i][1])
        out.append(whole)
    return _rebuild(shards[0], out)


def tree_bytes(tree: Tree) -> int:
    return sum(math.prod(t.shape) * t.element_size()
               for _, t in _paths(tree))


def zero1_local_dims(cfg: ModelConfig, specs: Tree, mesh: MeshLike,
                     layout: Optional[RankLayout] = None,
                     data_axis: str = "data") -> Dict[Tuple, Optional[int]]:
    """ZeRO-1 on the port's per-rank tensors: for each parameter path,
    the dim of the rank's slice (``layout``'s; None: the whole leaf) that
    its moments split over ``data`` — the dim :func:`zero1_specs` gives
    the full leaf (``specs``: its shapes, ``models.model.param_specs``),
    kept where the rank's length of it divides the data axis, else None
    (moments whole on every data rank)."""
    sizes = axis_sizes(mesh)
    ds = int(sizes.get(data_axis, 1))
    zspecs = zero1_specs(param_specs_tree(cfg, specs, mesh=sizes), specs,
                         {**sizes, data_axis: ds}, data_axis)
    out: Dict[Tuple, Optional[int]] = {}
    for (path, t), (_, zs) in zip(_paths(specs), _paths(zspecs)):
        shape = tuple(t.shape) if layout is None \
            else layout.local_shape(path, tuple(t.shape))
        dim = next((i for i, ax in enumerate(zs) if ax == data_axis), None)
        out[path] = dim if ds > 1 and dim is not None \
            and shape[dim] % ds == 0 and shape[dim] >= ds else None
    return out


def fsdp_local_shape(shape: Tuple[int, ...], spec: P, mesh: MeshLike
                     ) -> Tuple[int, ...]:
    """One rank's shape of a leaf under ``spec``."""
    sizes = axis_sizes(mesh)
    return tuple(d // _shards_of(ax, sizes) if ax is not None else d
                 for d, ax in zip(shape, tuple(spec) + (None,) * len(shape)))


def shard_fsdp_params(params: Tree, cfg: ModelConfig, mesh: MeshLike,
                      coords: Mapping[str, int], device=None) -> Tree:
    """The rank at ``coords``'s FSDP shards of the full parameters
    (:func:`fsdp_param_specs_tree`: a matrix's first dim over ``data``,
    replicated over ``model``): the weights of a context-parallel
    step."""
    specs = fsdp_param_specs_tree(cfg, params, mesh)
    out = []
    for (path, t), (_, sp) in zip(_paths(params), _paths(specs)):
        s = shard_tensor(t, sp, mesh, coords)
        out.append(s if device is None else s.to(device))
    return _rebuild(params, out)
