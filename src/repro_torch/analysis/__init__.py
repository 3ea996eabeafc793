"""Invariant analyzer for the port's serving stack, the reference's
``repro.analysis`` fitted to PyTorch (run ``python -m
repro_torch.analysis``; ``README.md`` beside this file).  Two passes
are pure AST over ``repro_torch/{serving,kernels,obs}``:

* ``hotpath_lint`` — Pass B: the schedule/submit/retire phase
  discipline (no host sync on the hot path, in torch's terms: ``.item()``,
  ``.cpu()``, ``.synchronize()``, a blocking host → device copy, ...)
  and the phase protocol (retire-only mutations unreachable from
  schedule/submit).
* ``lifecycle_check`` — Pass C: path-sensitive resource-lifecycle
  dataflow over ``serving/`` proving every acquire-shaped resource (KV
  blocks, state slots, run slots, adapter pins, staged weights) is
  released or transferred on every exit path.

The third, ``step_audit`` — Pass A — checks what one mixed step
dispatches (``ModelRunner.trace_mixed``, recorded by ``step_trace``):
ids-only payload, pools updated in place, no host round-trip, the
collective fingerprint, no param-sized upcast or data-dependent shape,
one program per bucket.  It imports the engine, so it is not imported
here.
"""
from repro_torch.analysis.hotpath_lint import Violation, lint_files, lint_tree
from repro_torch.analysis.lifecycle_check import check_files, check_tree

__all__ = ["Violation", "check_files", "check_tree", "lint_files",
           "lint_tree"]
