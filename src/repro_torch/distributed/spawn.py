"""Run a function of the port on N local ranks.

``launch(fn, *args, data=D, model=M)`` starts D × M processes (the
``spawn`` start method), joins them into one ``torch.distributed``
process group over a ``FileStore`` in a fresh temporary directory (so
concurrent launches, e.g. pytest-xdist workers, never race for a
port), builds the ``(data, model)`` mesh and calls ``fn(rank, *args)``
in each, where ``rank`` is a :class:`Rank` carrying the mesh and the
rank's coordinates.  It returns the ranks' results in rank order, and
raises :class:`RankError` with the rank's traceback if any rank raises,
dies or outlives ``timeout`` (every other rank is then terminated), so
a script that calls it exits non-zero.

Backends: CPU ranks use gloo, one intra-op thread each.  On a card,
ranks that each have a card of their own use NCCL; ranks that share a
card (more ranks than cards) use gloo too, since NCCL refuses two ranks
on one device, and gloo stages each collective's CUDA payload through
host memory.  The sharded step therefore uses only ``all_reduce``,
``all_gather`` and ``broadcast``, which both backends implement.

Under torchrun, :func:`from_env` joins the group torchrun describes
instead.
"""
from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, List

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class RankError(RuntimeError):
    """A rank of a :func:`launch` failed."""


@dataclass
class Rank:
    rank: int
    world: int
    coords: Dict[str, int]
    mesh: Any
    device: torch.device


def _backend(device: torch.device, world: int) -> str:
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _join(rank: int, world: int, data: int, model: int, device: str,
          init) -> Rank:
    from repro_torch.launch.mesh import make_host_mesh, mesh_coords
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' requested but "
                               "torch.cuda.is_available() is False")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    init(_backend(dev, world))
    mesh = make_host_mesh(data, model)
    return Rank(rank=rank, world=world, coords=mesh_coords(mesh), mesh=mesh,
                device=dev)


def _child(rank: int, world: int, data: int, model: int, device: str,
           store: str, timeout: float, fn: Callable, args: tuple,
           results) -> None:
    try:
        def init(backend):
            dist.init_process_group(
                backend, store=dist.FileStore(store, world), rank=rank,
                world_size=world, timeout=timedelta(seconds=timeout))
        r = _join(rank, world, data, model, device, init)
        results.put((rank, True, fn(r, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, *args, data: int = 1, model: int = 1,
           device="cuda", timeout: float = 900.0) -> List[Any]:
    """Run ``fn(rank, *args)`` on ``data × model`` local ranks; return
    their results in rank order.  ``fn`` and ``args`` must be picklable
    (a module-level function)."""
    world = data * model
    if world < 1:
        raise ValueError(f"mesh (data={data}, model={model})")
    dev = str(device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_child, args=(r, world, data, model, dev,
                                              store, timeout, fn, args,
                                              results))
             for r in range(world)]
    out: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            try:
                r, ok, val = results.get(timeout=1.0)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs) if i not in out
                        and p.exitcode not in (None, 0)]
                if not dead:
                    if time.monotonic() > deadline:
                        raise RankError(
                            f"ranks {sorted(set(range(world)) - set(out))}"
                            f" still running after {timeout:.0f} s")
                    continue
                try:        # the report a rank sent before it died
                    r, ok, val = results.get(timeout=5.0)
                except queue.Empty:
                    raise RankError(f"rank {dead[0]} exited with code "
                                    f"{procs[dead[0]].exitcode} and no "
                                    "result") from None
            if not ok:
                raise RankError(f"rank {r} of {world} failed:\n{val}")
            out[r] = val
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]


def from_env(data: int, model: int, device="cuda") -> Rank:
    """Join the process group torchrun describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ...) as a ``(data, model)`` mesh."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return _join(rank, world, data, model, str(device),
                 lambda backend: dist.init_process_group(backend))
