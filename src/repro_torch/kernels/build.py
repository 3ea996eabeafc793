"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together) and linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build
happens at first use, into ``build/repro_torch/`` at the root of the
checkout, and is keyed on a hash of the sources and flags, so a stale
library is never loaded.  A failed build raises with nvcc's output.

Each C entry point takes tensor pointers and the CUDA stream as
``void*``, launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the library's entry points (all return cudaError_t)
SIGNATURES = {
    # q, k_pool, v_pool, block_tables, req_rows, q_lens, out, part_acc,
    # part_ml, T, H, KV, hd, bs, nb, window, scale, is_bf16, stream
    "ragged_paged_attention": (P, P, P, P, P, P, P, P, P,
                               I, I, I, I, I, I, I, F, I, P),
    # x, (a, b, out) x 3, adapter_idx, active_slots, part, T, d, r,
    # out_dim x 3, n_pairs, n_slots, K, split, n_split, tiles, out_tiles,
    # tile0 x 3, is_bf16, stream
    "ragged_grouped_lora": (P, P, P, P, P, P, P, P, P, P, P, P, P,
                            I, I, I, I, I, I, I, I, I, I, I, I, I, I, I, I,
                            I, P),
    # x, B, C, dA, dt, seg_starts, slot_rows, init_states, out_rows, y,
    # states, T, H, N, P, M, grid_h, grid_p, stream
    "ragged_ssd_chunk_scan": (P, P, P, P, P, P, P, P, P, P, P,
                              I, I, I, I, I, I, I, P),
    # q, k_pool, v_pool, block_tables, lengths, out, part_acc, part_ml,
    # B, H, KV, hd, bs, nb, window, scale, is_bf16, stream
    "paged_attention": (P, P, P, P, P, P, P, P,
                        I, I, I, I, I, I, I, F, I, P),
    # x, B, C, dA, dt, y, state, Bt, S, H, N, P, chunk, cols, slices,
    # stages, stream
    "ssd_chunk_scan": (P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P),
    # x, w, a_stack, b_stack, adapter_idx, xa_part, xa, tile_part, out, T,
    # d, out_dim, n, r, rp, bm, bn, stages, split, ksteps, xa_split, xa_kc,
    # xa_blocks, reduce_blocks, is_bf16, stream
    "alora_qkv": (P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I,
                  I, I, I, I, I, I, P),
}

_lib: Optional[ctypes.CDLL] = None     # the process's loaded library


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on a machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, str]:
    """Compile and link the library if it is not built yet.  Returns its
    path and nvcc's resource report (empty when it was already built)."""
    so = library_path()
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                                 str(obj)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, obj, proc))
    logs, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode:
            failed.append(src.name)
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp = BUILD_DIR / f"{tag}.so.tmp"
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp, so)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return so, "\n".join(logs)


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        so, _ = build()
        lib = ctypes.CDLL(str(so))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def no_backward(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would need a gradient through kernel ``name``:
    the hand-written kernels have no backward (nor have the reference's
    Pallas kernels), and an output with no ``grad_fn`` would silently
    give its inputs a zero gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input "
            "requires grad; run it under torch.no_grad() (the training "
            "step passes no adapters)")


# the step recorder of ``analysis.step_trace`` while it records a step:
# a plain version then enters the record as one call, as its kernel
# launches once on the card
plain_recorder: Optional[Callable] = None


def run_plain(name: str, fn: Callable, *args, **kwargs):
    """Run kernel ``name``'s plain version ``fn`` (the path of CPU
    tensors), through the step recorder when one is recording."""
    rec = plain_recorder
    return fn(*args, **kwargs) if rec is None else rec(name, fn, args, kwargs)


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
