"""One rank's share of the sharded mixed step: its :class:`RankLayout`,
its process groups and the collectives the step runs.

The reference lets GSPMD insert the collectives; here they are explicit
and there are four kinds, all on the mesh's groups:

* ``reduce``: the row-parallel sum over ``model`` after Wo, w_down, the
  MoE experts and the SSM out_proj (and the SSM gated norm's sum of
  squares), each only where that part is split;
* ``embed``: the vocab-parallel lookup (rows outside the rank's range
  give zeros, then a sum over ``model``);
* ``gather_vocab``: the logits' all-gather over ``model`` on the padded
  vocab, so every rank takes the same argmax and holds the same token
  buffer;
* ``gather_rows``: with token sharding, the all-gather over ``data`` of
  whatever reads across rows (new K/V rows before the pool write, the
  SSM's xBC and dt rows before the conv and scan, the hidden rows before
  the logits).  Each data rank computes its own ``rows`` of the packed
  token axis otherwise.
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import axis_sizes, layout_of
from repro_torch.launch.mesh import mesh_coords


class TensorParallel:
    def __init__(self, cfg: ModelConfig, mesh, *,
                 data_shard_tokens: bool = True):
        sizes, coords = axis_sizes(mesh), mesh_coords(mesh)
        ms, ds = int(sizes["model"]), int(sizes.get("data", 1))
        self.layout = layout_of(cfg, mesh)
        self.lcfg = self.layout.local_cfg
        self.model_group = mesh.get_group("model") if ms > 1 else None
        # the packed token axis splits over ``data`` only when asked to;
        # otherwise every data rank computes the whole batch
        self.token_shards = ds if data_shard_tokens and ds > 1 else 1
        self.token_rank = coords["data"] if self.token_shards > 1 else 0
        self.data_group = mesh.get_group("data") \
            if self.token_shards > 1 else None

    def rows(self, n: int) -> slice:
        """This rank's rows of an ``n``-row packed token axis (every row
        without token sharding; ``n`` divides the data axis)."""
        k = n // self.token_shards
        return slice(self.token_rank * k, (self.token_rank + 1) * k)

    def reduce(self, y: torch.Tensor, part: str) -> torch.Tensor:
        """The sum over ``model`` of ``part``'s partial outputs (``part``:
        "attn", "mlp", "moe" or "ssm"); ``y`` unchanged where the part is
        whole on every rank."""
        if self.model_group is None or not getattr(self.layout, part):
            return y
        y = y.contiguous()
        dist.all_reduce(y, group=self.model_group)
        return y

    def _gather(self, x: torch.Tensor, group, dim: int) -> torch.Tensor:
        x = x.contiguous()
        parts: List[torch.Tensor] = [torch.empty_like(x) for _ in
                                     range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        if self.data_group is None:
            return x
        return self._gather(x, self.data_group, 0)

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        if self.model_group is None or not self.layout.vocab:
            return logits
        return self._gather(logits, self.model_group, -1)

    def embed(self, tok: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of the embedding whose rank slice is ``tok``."""
        if self.model_group is None or not self.layout.vocab:
            return torch.index_select(tok, 0, ids)
        rows = self.layout.vocab_rows
        local = ids - rows.start
        inside = (local >= 0) & (local < len(rows))
        e = torch.index_select(tok, 0, local.clamp(0, len(rows) - 1))
        e = torch.where(inside[:, None], e, torch.zeros_like(e))
        dist.all_reduce(e, group=self.model_group)
        return e
