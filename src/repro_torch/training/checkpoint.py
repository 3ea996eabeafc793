"""Checkpoints: one flat-key ``.npz`` of a parameter tree plus a JSON
manifest (step and keys), the reference's ``repro/training/checkpoint.py``
format over the port's tree (keys are the tree paths joined by "/", list
indices as numbers, e.g. ``layers/0/attn/wq``).  bfloat16 leaves are
stored as float32 (exact; numpy has no bfloat16) and restored in the
dtype and on the device of the tree they are restored into.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.common import tree_map, tree_paths


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _flatten(tree) -> Dict[str, np.ndarray]:
    flat = {}
    for path, leaf in tree_paths(tree):
        t = leaf.detach().cpu()
        flat[_key(path)] = (t.float() if t.dtype == torch.bfloat16
                            else t).numpy()
    return flat


def save_checkpoint(path: str, tree, step: int = 0) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    np.savez(path, **flat)
    with open(path + ".manifest.json", "w") as f:
        json.dump({"step": step, "keys": sorted(flat)}, f)


def restore_checkpoint(path: str, tree_like) -> Any:
    """A tree like ``tree_like`` (its structure, dtypes and devices) with
    the checkpoint's values; raises ``ValueError`` when a leaf's shape
    differs and ``KeyError`` when one is missing."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    keys = iter(_key(p) for p, _ in tree_paths(tree_like))

    def load(leaf):
        key = next(keys)
        arr = data[key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint {arr.shape} vs model "
                             f"{tuple(leaf.shape)}")
        return torch.from_numpy(arr).to(device=leaf.device,
                                        dtype=leaf.dtype)
    return tree_map(load, tree_like)


def checkpoint_step(path: str) -> int:
    with open(path + ".manifest.json") as f:
        return json.load(f)["step"]
