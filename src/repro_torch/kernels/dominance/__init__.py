"""The pairwise dominance test: :func:`dominated_mask` is its one entry.

Counterpart of ``repro.kernels.dominance``: callers outside the kernels
package import from here, never a submodule (``kernel``, ``ops``,
``ref``; lint rule R3 of ``repro_torch.analysis``).  The oracle and the
subnormal flush come from ``ref``, which imports nothing of the
package.  The entry is exported lazily (PEP 562): ``ops`` imports the
backend registry, which imports ``kernel`` for its limits, so an eager
import here would close an import cycle through this package.
"""

from repro_torch.kernels.dominance.ref import (dominance_matrix_ref,
                                              dominated_mask_ref,
                                              flush_subnormal)

__all__ = ["dominated_mask", "dominance_matrix_ref", "dominated_mask_ref",
           "flush_subnormal"]


def __getattr__(name):
    if name == "dominated_mask":
        from repro_torch.kernels.dominance.ops import dominated_mask
        return dominated_mask
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
