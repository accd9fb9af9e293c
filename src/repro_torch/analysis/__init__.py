"""Static verification of the port's dispatch discipline.

Counterpart of ``repro.analysis``.  Two layers gate the invariants the
paper's parallel-skyline cost model assumes (one launch wave per feed,
the kernels' launches independent of the query count):

* Layer 1, **skylint** (`repro_torch.analysis.lint`): AST rules R1-R6
  over ``src/repro_torch``: no host syncs in pipeline-reachable code or
  the serving hot paths, no per-item device copies in pack paths, kernel
  call sites through the kernel packages and the backend registry,
  torch.distributed only in the mesh module, no Python branching on
  tensors in ``core/``, state updates that honour donation.  Imports
  neither torch nor jax; runs anywhere.
* Layer 2, **program verifier** (`repro_torch.analysis.verifier`): runs
  the program suite (`repro_torch.launch.cells`) under a census of the
  dispatched operations and asserts: no host round-trips, no
  collectives, Q-independent operation counts, slab boundary shapes,
  in-place state updates and the kernels' shared-memory cap; on the
  card also no sync under ``set_sync_debug_mode("error")``, equal CUDA
  graph kernel counts at q and 2q, and a peak-memory budget.

CLI: ``python -m repro_torch.analysis`` (JSON report, non-zero exit on
any active finding).  Rules, suppressions and the baseline are
documented in ``src/repro_torch/analysis/README.md``.

This module imports only the torch-free layer; import
`repro_torch.analysis.verifier` explicitly for Layer 2.
"""

from repro_torch.analysis.findings import Finding, load_baseline, write_baseline
from repro_torch.analysis.lint import lint_paths
from repro_torch.analysis.rules import RULES

__all__ = ["Finding", "RULES", "lint_paths", "load_baseline",
           "write_baseline"]
