"""What the traced run (``--trace 1``) records, from the benchmark's own
files around the calls into the program:

* each mixed step's shapes, from a wrapper of ``ModelRunner.submit_batch``
  (tokens, request rows, contexts, adapted rows, SSM segments; during the
  profiled steps also the bytes and operations of B1 and B3);
* host spans of the engine's and the runner's phases (admission, batch
  assembly, enqueue, the sampled-ids fetch, retire), from wrappers of
  their methods, while the profiler runs;
* a ``torch.profiler`` window of a few steps (device activity only),
  its kernels mapped onto the host clock.

The wrappers call straight through; the program is not edited."""
from __future__ import annotations

import functools
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from alora_bench import yardstick as Y

WARM_STEPS = 3
B1_KERNELS = ("paged_attention_tile_kernel", "paged_attention_merge_kernel")
B3_KERNELS = ("ragged_ssd_scan_kernel",)

HOST_SPANS = {                 # (owner, method) -> span name
    ("eng", "step"): "step",
    ("eng", "_try_admit"): "admit",
    ("eng", "_submit_mixed"): "submit",
    ("eng", "_retire"): "retire",
    ("runner", "build_input_embeds"): "admit.embed_copy",
    ("runner", "_assemble_mixed"): "submit.assemble",
    ("runner", "_mixed_impl"): "submit.enqueue",
    ("runner", "fetch_sampled"): "retire.fetch_sampled",
}


@functools.lru_cache(maxsize=None)
def _ssd_ops(n: int, N: int, P: int, from_zero: bool) -> int:
    return Y.ssd_ops(n, N, P, from_zero)


class Recorder:
    """Instruments one engine for the traced run."""

    def __init__(self, eng, dims: Dict[str, Any], profile_steps: int):
        self.eng, self.dims = eng, dims
        self.calls: List[Dict[str, Any]] = []
        self.spans: List[Tuple[str, float, float]] = []
        self.profiling = False
        self.profile_steps = profile_steps
        self.prof = None
        self.profile: Optional[Dict[str, Any]] = None
        self._steps_left = 0
        self._clock0: Tuple[int, float] = (0, 0.0)
        self._start_at: Optional[float] = None
        self.La = dims["kinds"].count("attn")
        self.Ls = dims["kinds"].count("ssm")
        runner = eng.runner
        for (owner, meth), name in HOST_SPANS.items():
            obj = eng if owner == "eng" else runner
            setattr(obj, meth, self._span(name, getattr(obj, meth)))
        inner = runner.submit_batch
        setattr(runner, "submit_batch", self._calls(inner))

    # ------------------------------------------------------------------
    def _span(self, name, fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            if not self.profiling:
                return fn(*a, **k)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.spans.append((name, t0, time.perf_counter()))
        return wrapped

    def _calls(self, fn):
        @functools.wraps(fn)
        def wrapped(mb):
            self.calls.append(self.summarise(mb))
            return fn(mb)
        return wrapped

    def summarise(self, mb) -> Dict[str, Any]:
        """The work of one mixed step, from its batch."""
        d = self.dims
        pos = np.asarray(mb.positions, dtype=np.int64)
        rows = np.asarray(mb.req_rows, dtype=np.int64)
        R = len(mb.block_tables)
        T = int(pos.shape[0])
        C = 0 if mb.snap_rows is None else int(len(mb.snap_rows))
        rec = {"t": time.perf_counter(), "T": T, "R": R, "C": C,
               "ctx": int((pos + 1).sum()),
               "adapted": int(np.count_nonzero(mb.adapter_idx)),
               "profiled": self.profiling}
        if self.Ls:
            seg = np.bincount(rows, minlength=R)
            first = np.full(R, np.iinfo(np.int64).max)
            np.minimum.at(first, rows, pos)
            s = d["ssm"]
            rec["ssd_ops"] = sum(
                d["ssm_heads"] * _ssd_ops(int(n), s["state_dim"],
                                          s["head_dim"], bool(f == 0))
                for n, f in zip(seg, first) if n)
        if self.profiling:
            es = Y.ELEMENT_BYTES[d["dtype"]]
            if self.La:
                width = 1
                while width < max((len(t) for t in mb.block_tables),
                                  default=1):
                    width *= 2
                nb, ops = Y.ragged_attention_work(
                    H=d["num_heads"], KV=d["num_kv_heads"], hd=d["head_dim"],
                    bs=self.eng.ecfg.block_size, q_lens=pos + 1,
                    req_rows=rows, block_tables=mb.block_tables,
                    table_width=width, es=es)
                rec["b1_bound_s"] = self.La * Y.bound_s(nb, ops, d["dtype"])
            if self.Ls:
                s = d["ssm"]
                nb, ops = Y.ragged_ssd_work(
                    H=d["ssm_heads"], N=s["state_dim"], P=s["head_dim"],
                    seg_lens=[int(n) for n in seg if n],
                    seg_from_zero=[bool(f == 0) for n, f in zip(seg, first)
                                   if n], n_kept=R + C)
                rec["b3_bound_s"] = self.Ls * Y.bound_s(nb, ops, "float32")
        return rec

    # ------------------------------------------------------------------
    def schedule_profile(self, at: float) -> None:
        """Profile ``profile_steps`` steps from host time ``at`` on."""
        self._start_at = at

    def before_step(self, now: float) -> None:
        if self._start_at is not None and now >= self._start_at \
                and self.prof is None and self.profile is None:
            self._start()
        elif self.prof is not None:
            self._steps_left -= 1
            if self._steps_left == 0:
                self._open()
            elif self._steps_left <= -self.profile_steps:
                self._stop()

    def finish(self) -> None:
        if self.prof is not None:
            self._stop()

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self._clock0 = (time.time_ns(), time.perf_counter())
        # a few steps under the profiler before the window, which then
        # opens on an idle card: the first traced launches pay its set-up
        self._steps_left = WARM_STEPS

    def _open(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.profiling = True
        self._t_start = time.perf_counter()

    def _stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        opened, self.profiling = self.profiling, False
        self.prof.stop()
        if not opened:                  # the window closed first
            self.prof = None
            return
        ns0, pc0 = self._clock0
        kernels = []
        for e in self.prof.profiler.kineto_results.events():
            if not str(e.device_type()).endswith("CUDA"):
                continue
            a = pc0 + (e.start_ns() - ns0) / 1e9
            kernels.append((e.name(), a, a + e.duration_ns() / 1e9))
        self.prof = None
        # the window opens at the first device operation of the profiled
        # steps: before it the card idles only because of the sync that
        # drained the warm-up steps
        t0 = min((a for _, a, _ in kernels if a >= self._t_start),
                 default=self._t_start)
        self.profile = {"t0": t0, "t1": t_end, "kernels": kernels,
                        "steps": self.profile_steps}
