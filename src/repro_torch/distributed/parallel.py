"""One rank's share of a sharded step: its :class:`RankLayout`, its
process groups and the collectives the step runs.

The reference lets GSPMD insert the collectives; here they are explicit
and all on the mesh's groups:

* ``reduce``: the row-parallel sum over ``model`` after Wo, w_down, the
  MoE experts and the SSM out_proj, each only where that part is split;
  ``norm_sum``: the SSM gated norm's sum of squares over ``model``;
* ``embed``: the vocab-parallel lookup (rows outside the rank's range
  give zeros, then a sum over ``model``);
* ``gather_vocab``: the logits' all-gather over ``model`` on the padded
  vocab, so every rank takes the same argmax and holds the same token
  buffer;
* ``gather_rows``: with token sharding (the serving mixed step), the
  all-gather over ``data`` of whatever reads across rows (new K/V rows
  before the pool write, the SSM's xBC and dt rows before the conv and
  scan, the hidden rows before the logits).  Each data rank computes its
  own ``rows`` of the packed token axis otherwise;
* ``enter``: where a part is split, the identity on its input, whose
  gradient is summed over ``model`` (the input feeds every rank's
  column slice).

Under autograd (training, the context-parallel gradients) the sums and
gathers are ``torch.autograd.Function``\\ s, Megatron-LM's conjugate
pair: ``enter`` is its *f* (forward identity, backward all_reduce),
``reduce`` and ``embed`` its *g* (forward all_reduce, backward
identity), ``gather_vocab``'s backward takes the rank's slice, and
``norm_sum`` all-reduces in both directions (each rank normalises only
its own channels with the sum, so the gradient reaching it differs per
rank).  Without a gradient to carry they are the plain ``dist`` calls.

Every collective goes through :func:`all_reduce` / :func:`all_gather`,
which count it in :data:`COLLECTIVES` by kind (the reference's HLO
names: ``all-reduce``, ``all-gather``) with its result bytes on this
rank, the quantity ``launch.hlo_analysis.CollectiveStats`` holds.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (_paths, axis_sizes,
                                              fsdp_param_specs_tree,
                                              layout_of)
from repro_torch.launch.mesh import mesh_coords

# kind -> {"count": calls, "bytes": result bytes on this rank}
COLLECTIVES: Dict[str, Dict[str, int]] = {}


def reset_collectives() -> None:
    COLLECTIVES.clear()


def _count(kind: str, t: torch.Tensor) -> None:
    c = COLLECTIVES.setdefault(kind, {"count": 0, "bytes": 0})
    c["count"] += 1
    c["bytes"] += t.numel() * t.element_size()


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (in place on a contiguous copy;
    returned)."""
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    _count("all-reduce", x)
    return x


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` concatenated along ``dim``."""
    x = x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in
                                 range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim=dim)
    _count("all-gather", out)
    return out


class _Enter(torch.autograd.Function):
    """Megatron's f: identity forward, sum over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """Megatron's g: sum over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBoth(torch.autograd.Function):
    """A sum over the group whose gradient is summed too: every rank
    uses the total on its own slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; backward keeps the rank's slice."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


class _GatherSummed(torch.autograd.Function):
    """All-gather along ``dim`` over ``group``; backward sums the
    gradient over ``sum_group`` (every rank that used the gathered
    tensor), then keeps the rank's slice.  The context-parallel K/V and
    FSDP weights."""

    @staticmethod
    def forward(ctx, x, group, sum_group, dim):
        ctx.dim, ctx.n, ctx.sum_group = dim, x.shape[dim], sum_group
        ctx.rank = dist.get_rank(group) if group is not None else 0
        return x.view_as(x) if group is None else all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_group is not None:
            g = all_reduce(g, ctx.sum_group)
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def gather_summed(x: torch.Tensor, group, sum_group, dim: int
                  ) -> torch.Tensor:
    """``x`` gathered over ``group`` along ``dim`` (None: ``x``); under
    autograd its gradient is summed over ``sum_group`` before the
    rank's slice is taken."""
    if _grad(x):
        return _GatherSummed.apply(x, group, sum_group, dim)
    return x if group is None else all_gather(x, group, dim)


def mean_over(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The mean of ``x`` over ``group`` of ``n`` ranks (None: ``x``);
    the gradient reaches each rank's own ``x`` scaled by 1/n."""
    if group is None:
        return x
    s = _Reduce.apply(x, group) if _grad(x) else all_reduce(x.clone(), group)
    return s / n


class MeshRank:
    """A rank's place on a ("data", "model") mesh: the axes' sizes, its
    coordinates, the groups of its axes (None where an axis has one
    rank) and its rows of a batch split over ``data``."""

    def __init__(self, mesh):
        self.sizes, coords = axis_sizes(mesh), mesh_coords(mesh)
        self.ms = int(self.sizes["model"])
        self.ds = int(self.sizes.get("data", 1))
        self.model_rank, self.data_rank = coords["model"], coords.get("data",
                                                                      0)
        self.model_group = mesh.get_group("model") if self.ms > 1 else None
        # batch rows, gradients, ZeRO-1 and the serving step's token shards
        self.data_group = mesh.get_group("data") if self.ds > 1 else None

    def batch_rows(self, n: int) -> slice:
        """This data rank's rows of an ``n``-row batch: its block where
        ``n`` divides the data axis, else every row (a replicated batch,
        as the reference's long_500k at B = 1)."""
        if not self.batch_sharded(n):
            return slice(0, n)
        k = n // self.ds
        return slice(self.data_rank * k, (self.data_rank + 1) * k)

    def batch_sharded(self, n: int) -> bool:
        return self.data_group is not None and n % self.ds == 0


class TensorParallel(MeshRank):
    def __init__(self, cfg: ModelConfig, mesh, *,
                 data_shard_tokens: bool = True):
        super().__init__(mesh)
        self.layout = layout_of(cfg, mesh)
        self.lcfg = self.layout.local_cfg
        # the packed token axis splits over ``data`` only when asked to;
        # otherwise every data rank computes the whole batch
        self.token_shards = self.ds if data_shard_tokens and self.ds > 1 \
            else 1
        self.token_rank = self.data_rank if self.token_shards > 1 else 0

    def rows(self, n: int) -> slice:
        """This rank's rows of an ``n``-row packed token axis (every row
        without token sharding; ``n`` divides the data axis)."""
        k = n // self.token_shards
        return slice(self.token_rank * k, (self.token_rank + 1) * k)

    def _split(self, part: str) -> bool:
        return self.model_group is not None and getattr(self.layout, part)

    def enter(self, x: torch.Tensor, part: str) -> torch.Tensor:
        """``x`` as the input of ``part``'s column-parallel products:
        itself; under autograd its gradient is summed over ``model``
        where the part is split."""
        if self._split(part) and _grad(x):
            return _Enter.apply(x, self.model_group)
        return x

    def reduce(self, y: torch.Tensor, part: str) -> torch.Tensor:
        """The sum over ``model`` of ``part``'s partial outputs (``part``:
        "attn", "mlp", "moe" or "ssm"); ``y`` unchanged where the part is
        whole on every rank."""
        if not self._split(part):
            return y
        if _grad(y):
            return _Reduce.apply(y, self.model_group)
        return all_reduce(y, self.model_group)

    def norm_sum(self, s: torch.Tensor) -> torch.Tensor:
        """The SSM gated norm's sum of squares over ``model``."""
        if not self._split("ssm"):
            return s
        if _grad(s):
            return _SumBoth.apply(s, self.model_group)
        return all_reduce(s, self.model_group)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        if self.token_shards == 1:
            return x
        return all_gather(x, self.data_group, 0)

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        if not self._split("vocab"):
            return logits
        if _grad(logits):
            return _Gather.apply(logits, self.model_group, logits.dim() - 1)
        return all_gather(logits, self.model_group, -1)

    def embed(self, tok: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of the embedding whose rank slice is ``tok``."""
        if not self._split("vocab"):
            return torch.index_select(tok, 0, ids)
        rows = self.layout.vocab_rows
        local = ids - rows.start
        inside = (local >= 0) & (local < len(rows))
        e = torch.index_select(tok, 0, local.clamp(0, len(rows) - 1))
        e = torch.where(inside[:, None], e, torch.zeros_like(e))
        return self.reduce(e, "vocab")


class ContextParallel(MeshRank):
    """One rank's share of a context-parallel forward (the reference's
    ``Runtime.context_parallel``, dense decoder-only models): its rows of
    the batch over ``data``, its block of the sequence over ``model``,
    the weights FSDP-sharded over ``data`` (``fsdp_param_specs_tree``:
    a matrix's first dim) and all-gathered before each use, K/V
    all-gathered over ``model`` so that each rank's queries see the
    whole sequence.  Under autograd every gathered weight's gradient is
    summed over all ranks (each used it on its own tokens) before the
    rank keeps its shard, and K/V's over ``model``."""

    def __init__(self, cfg: ModelConfig, mesh, specs):
        super().__init__(mesh)
        self.world = dist.group.WORLD if self.ms * self.ds > 1 else None
        fsdp = fsdp_param_specs_tree(cfg, specs, self.sizes)
        self.sharded = {path: len(sp) > 0 and sp[0] == "data"
                        for path, sp in _paths(fsdp)}
        self.local_shapes = {
            path: (t.shape[0] // self.ds,) + tuple(t.shape[1:])
            if self.sharded[path] else tuple(t.shape)
            for path, t in _paths(specs)}

    def check(self, params, cfg: ModelConfig, extra_embeds) -> None:
        if cfg.arch_type != "dense" or extra_embeds is not None:
            raise ValueError(f"{cfg.name}: context-parallel prefill is for "
                             "dense decoder-only models")
        for path, t in _paths(params):
            if tuple(t.shape) != self.local_shapes[path]:
                raise ValueError(
                    f"params {'/'.join(map(str, path))}: shape "
                    f"{tuple(t.shape)} is not the rank's FSDP shard "
                    f"{self.local_shapes[path]} "
                    "(distributed.sharding.shard_fsdp_params)")

    def param(self, path, t: torch.Tensor) -> torch.Tensor:
        """The whole weight at ``path`` from the rank's shard ``t``."""
        return gather_summed(t, self.data_group if self.sharded[path]
                             else None, self.world, 0)

    def gather(self, prefix: tuple, tree):
        return {k: self.gather(prefix + (k,), v) if isinstance(v, dict)
                else self.param(prefix + (k,), v) for k, v in tree.items()}

    def seq_cols(self, S: int) -> slice:
        if S % self.ms:
            raise ValueError(f"sequence {S} does not divide the model axis "
                             f"{self.ms}")
        k = S // self.ms
        return slice(self.model_rank * k, (self.model_rank + 1) * k)

    def attention(self, q, k, v, causal: bool, window: int) -> torch.Tensor:
        """Flash attention of the rank's query block over the whole
        sequence's K/V, at the block's absolute offset."""
        from repro_torch.models.attention import flash_attention
        kf = gather_summed(k, self.model_group, self.model_group, 1)
        vf = gather_summed(v, self.model_group, self.model_group, 1)
        return flash_attention(q, kf, vf, causal=causal, window=window,
                               q_offset=self.model_rank * q.shape[1])


def context_parallel(cfg: ModelConfig, mesh, specs) -> ContextParallel:
    """The rank's :class:`ContextParallel` on ``mesh``, cached per
    (configuration, mesh); ``specs``: the full parameter shapes
    (``models.model.param_specs``)."""
    key = ("cp", cfg, id(mesh))
    if key not in _TP:
        _TP[key] = (mesh, ContextParallel(cfg, mesh, specs))
    return _TP[key][1]


def tensor_parallel(cfg: ModelConfig, mesh) -> Optional[TensorParallel]:
    """The full-sequence model's :class:`TensorParallel` on ``mesh``
    (None: no mesh), cached per (configuration, mesh)."""
    if mesh is None:
        return None
    key = (cfg, id(mesh))
    if key not in _TP:              # the mesh is kept, so its id is not reused
        _TP[key] = (mesh, TensorParallel(cfg, mesh, data_shard_tokens=False))
    return _TP[key][1]


_TP: Dict = {}
