"""Small helpers shared across the port: device resolution and a map
over nested parameter dictionaries (the port's stand-in for pytrees)."""
from __future__ import annotations

from typing import Any, Callable

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  Entry points default to
    ``"cuda"``; asking for a card where there is none raises instead of
    continuing quietly on the CPU — callers that want the plain CPU
    versions pass ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to the leaves of nested dicts/lists (with matching
    structure in ``rest``), rebuilding the containers."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_paths(tree: Any, prefix: tuple = ()) -> list:
    """(path, leaf) pairs of nested dicts/lists in order; a path holds
    the keys and list indices down to its leaf."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in tree_paths(v, prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def tree_at(tree: Any, path) -> Any:
    """The leaf of ``tree`` at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
