"""Static invariant analyzer for the port's serving stack, the
reference's ``repro.analysis`` fitted to PyTorch.  Two passes, both pure
AST over ``repro_torch/{serving,kernels,obs}`` (run
``python -m repro_torch.analysis``):

* ``hotpath_lint`` — Pass B: the schedule/submit/retire phase
  discipline (no host sync on the hot path, in torch's terms: ``.item()``,
  ``.cpu()``, ``.synchronize()``, a blocking host → device copy, ...)
  and the phase protocol (retire-only mutations unreachable from
  schedule/submit).
* ``lifecycle_check`` — Pass C: path-sensitive resource-lifecycle
  dataflow over ``serving/`` proving every acquire-shaped resource (KV
  blocks, state slots, run slots, adapter pins, staged weights) is
  released or transferred on every exit path.

The reference's Pass A (``step_audit``, the compiled-step audit) has no
counterpart until the port's step is captured (ROADMAP A8, A13b).
"""
from repro_torch.analysis.hotpath_lint import Violation, lint_files, lint_tree
from repro_torch.analysis.lifecycle_check import check_files, check_tree

__all__ = ["Violation", "check_files", "check_tree", "lint_files",
           "lint_tree"]
