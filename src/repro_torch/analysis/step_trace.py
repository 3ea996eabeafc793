"""The recorder behind Pass A (``analysis.step_audit``): what one eager
mixed step dispatches, in the form the audit's checks read.

The reference audits the compiled module of its mixed step.  The port's
step is eager, so its counterpart of that module is the sequence of
operations one ``ModelRunner._mixed_impl`` call dispatches.
``ModelRunner.trace_mixed`` runs the step under a :class:`Recorder`,
which collects:

* every aten operation, through a ``TorchDispatchMode``: its name and
  the shape, dtype, device and storage of each tensor it takes and
  returns (a plain version, the path of CPU tensors, enters as one call
  named ``plain:<kernel>``, as its kernel launches once on the card:
  ``kernels.build.run_plain``);
* the launches of the hand-written kernels, from their wrappers'
  ``.launches`` counters (they launch through ``ctypes``, which the
  dispatcher never sees);
* the collectives, from ``distributed.parallel.COLLECTIVES`` (reset
  before the step, read after it);
* the ``_version`` of every persistent tensor (params, adapter stacks,
  snapshot and encoder pools) and the ``data_ptr``/``_version`` of each
  pool the step updates in place, before and after.

On a card the step also runs under ``torch.cuda.set_sync_debug_mode(
"error")``, which raises on any synchronising CUDA call the operation
record could miss; the message is kept in ``StepTrace.sync_error``.  The
exception is a rank of a gloo world (ranks sharing one card): gloo
stages every collective's payload through host memory and synchronises
on its own threads by design, and the debug mode is global, so there
the operation record alone stands (``StepTrace.sync_guarded`` False).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.common import tree_paths
from repro_torch.distributed import parallel
from repro_torch.kernels import build, launch_counts
# the state one mixed step updates in place (``OUT_NAMES``' pools)
IN_PLACE = ("k_pool", "v_pool", "live_ssm", "live_conv", "tok_buf")
# operations that index with a mask or a list of tensors
_INDEXING = ("aten.index.", "aten.index_put", "aten._index_put_impl_")


@dataclass(frozen=True)
class TensorMeta:
    shape: Tuple[int, ...]
    dtype: str            # "bfloat16", "float32", "int32", ...
    device: str           # "cpu", "cuda"
    storage: int = 0      # its storage's data_ptr (0: none)

    @property
    def nbytes(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n * getattr(torch, self.dtype).itemsize

    def key(self) -> Tuple:
        return (self.shape, self.dtype)


@dataclass(frozen=True)
class Op:
    """One dispatched operation; ``bool_index``: an index by a bool
    tensor (its result's shape depends on the mask's values)."""
    name: str
    ins: Tuple[TensorMeta, ...] = ()
    outs: Tuple[TensorMeta, ...] = ()
    bool_index: bool = False

    def key(self) -> Tuple:
        return (self.name, tuple(m.key() for m in self.ins),
                tuple(m.key() for m in self.outs))


@dataclass
class PoolState:
    """A pool the step should update in place, before and after."""
    meta: TensorMeta
    ptr_before: int
    ptr_after: int
    version_before: int
    version_after: int


@dataclass
class StepTrace:
    """What one mixed step did (see the module docstring).  ``outputs``:
    the tensors ``_mixed_impl`` returned, by slot name (``sampled``,
    ``b_ssm``, ``b_conv``); ``persistent``: path → (version before,
    after), ``names`` their paths by storage; ``bucket``: the step's
    pow2 buckets (``ModelRunner.buckets``); ``argument_bytes``: the
    uploaded step
    tensors; ``temp_bytes``: on a card, the rise of the peak allocation
    over the step."""
    device: str
    ops: List[Op] = field(default_factory=list)
    launches: Dict[str, int] = field(default_factory=dict)
    collectives: Dict[str, Dict[str, int]] = field(default_factory=dict)
    outputs: List[Tuple[str, TensorMeta]] = field(default_factory=list)
    pools: Dict[str, PoolState] = field(default_factory=dict)
    persistent: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    # storage data_ptr -> path of each persistent tensor
    names: Dict[int, str] = field(default_factory=dict)
    bucket: Tuple[int, ...] = ()
    argument_bytes: int = 0
    temp_bytes: Optional[int] = None
    sync_error: str = ""
    sync_guarded: bool = False

    def plain_calls(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for op in self.ops:
            if op.name.startswith("plain:"):
                out[op.name[6:]] = out.get(op.name[6:], 0) + 1
        return out

    def signature(self) -> Tuple:
        """What two steps of one bucket must share: every operation with
        its shapes and dtypes, and the kernel launches."""
        return (tuple(op.key() for op in self.ops),
                tuple(sorted(self.launches.items())))


def meta_of(t: torch.Tensor) -> TensorMeta:
    try:
        storage = t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        storage = 0
    return TensorMeta(tuple(t.shape), str(t.dtype).replace("torch.", ""),
                      t.device.type, storage)


def _metas(tree) -> Tuple[TensorMeta, ...]:
    return tuple(meta_of(t) for t in tree_leaves(tree)
                 if isinstance(t, torch.Tensor))


class Recorder(TorchDispatchMode):
    """Records the operations dispatched while it is entered, each plain
    version as one call (``kernels.build.plain_recorder``)."""

    def __init__(self):
        super().__init__()
        self.ops: List[Op] = []
        self._plain = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._plain:
            name = str(func)
            bool_index = name.startswith(_INDEXING) and len(args) > 1 and any(
                isinstance(t, torch.Tensor) and t.dtype == torch.bool
                for t in tree_leaves(args[1]))
            self.ops.append(Op(name, _metas((args, kwargs)), _metas(out),
                               bool_index))
        return out

    def _run_plain(self, name, fn, args, kwargs):
        self._plain += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._plain -= 1
        self.ops.append(Op(f"plain:{name}", _metas((args, kwargs)),
                           _metas(out)))
        return out

    def __enter__(self):
        build.plain_recorder = self._run_plain
        return super().__enter__()

    def __exit__(self, *exc):
        build.plain_recorder = None
        return super().__exit__(*exc)


def persistent_tensors(runner) -> Dict[str, torch.Tensor]:
    """Every tensor a mixed step must leave untouched, by path: the
    params (``params/layers/3/ssm/out_proj``), the adapter slot stacks,
    the snapshot and encoder pools."""
    out: Dict[str, torch.Tensor] = {}
    for root, tree in (("params", runner.params),
                       ("adapters", runner.adapter_layers)):
        for path, t in tree_paths(tree):
            if isinstance(t, torch.Tensor):
                out["/".join(map(str, (root,) + tuple(path)))] = t
    for name in ("snap_ssm", "snap_conv", "xk_pool", "xv_pool"):
        t = getattr(runner, name)
        if t is not None:
            out[name] = t
    return out


class StepRecording:
    """Around one traced step (``ModelRunner.trace_mixed``): entered
    after the runner's in-place state was swapped for clones, it notes
    every pool's ``data_ptr`` and ``_version``, the persistent tensors'
    versions, the launch counters; it resets the collective counter and,
    on a card, the peak-memory statistics, and sets the sync debug mode
    to "error" (not on a rank of a gloo world).  Entering
    :attr:`recorder` records the operations; on exit :attr:`trace`
    holds the :class:`StepTrace`.  A synchronising CUDA
    call the debug mode raised on ends the step and is kept in
    ``trace.sync_error``."""

    def __init__(self, runner, bucket: Tuple[int, ...]):
        self.runner = runner
        self.cuda = runner.device.type == "cuda"
        self.trace = StepTrace(device=runner.device.type,
                               bucket=tuple(bucket))
        self.trace.sync_guarded = self.cuda and not (
            runner.tp is not None and dist.get_backend() == "gloo")
        self.recorder = Recorder()

    def __enter__(self) -> "StepRecording":
        r = self.runner
        self.pools = {n: (getattr(r, n), getattr(r, n).data_ptr(),
                          getattr(r, n)._version)
                      for n in IN_PLACE if getattr(r, n) is not None}
        self.persistent = persistent_tensors(r)
        self.versions = {k: t._version for k, t in self.persistent.items()}
        self.launches = launch_counts()
        parallel.reset_collectives()
        if self.cuda:
            torch.cuda.synchronize(r.device)
            torch.cuda.reset_peak_memory_stats(r.device)
            self.base = torch.cuda.memory_allocated(r.device)
        if self.trace.sync_guarded:
            self.debug_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        return self

    def returned(self, ret) -> None:
        """``_mixed_impl``'s return value ``(sampled, boundary)``, the
        boundary None or ``(b_ssm, b_conv)``, by slot name."""
        sampled, boundary = ret
        self.trace.outputs = [("sampled", meta_of(sampled))]
        if boundary is not None:
            self.trace.outputs += [(n, meta_of(t)) for n, t in
                                   zip(("b_ssm", "b_conv"), boundary)]

    def uploaded(self, meta, cross) -> None:
        """The step's uploaded tensors (``_assemble_mixed``'s result)."""
        ups = list(meta) + ([] if cross is None else list(cross[:2]))
        self.trace.argument_bytes = sum(t.numel() * t.element_size()
                                        for t in ups)

    def __exit__(self, kind, err, tb) -> bool:
        r, t = self.runner, self.trace
        sync = False
        if t.sync_guarded:
            torch.cuda.set_sync_debug_mode(self.debug_mode)
            sync = kind is not None and issubclass(kind, RuntimeError) \
                and "synchroniz" in str(err)
            if sync:
                t.sync_error = str(err).splitlines()[0]
        if self.cuda:
            torch.cuda.synchronize(r.device)
            t.temp_bytes = torch.cuda.max_memory_allocated(r.device) \
                - self.base
        t.ops = self.recorder.ops
        now = launch_counts()
        t.launches = {k: now[k] - self.launches[k] for k in now}
        t.collectives = {k: dict(v) for k, v in
                         sorted(parallel.COLLECTIVES.items())}
        for n, (pool, ptr, ver) in self.pools.items():
            after = getattr(r, n)
            t.pools[n] = PoolState(meta_of(pool), ptr, after.data_ptr(), ver,
                                   after._version)
        t.persistent = {k: (self.versions[k], v._version)
                        for k, v in self.persistent.items()}
        t.names = {v.untyped_storage().data_ptr(): k
                   for k, v in self.persistent.items()}
        return sync
