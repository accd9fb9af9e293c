"""The pairwise dominance test: ``ops.dominated_mask`` is its one entry.

Submodules are imported by their users (``ops``, ``kernel``, ``ref``), so
that importing the backend registry, which reads the kernel's limits,
does not import the entry.
"""

from repro_torch.kernels.dominance.ref import (dominance_matrix_ref,
                                              dominated_mask_ref)

__all__ = ["dominance_matrix_ref", "dominated_mask_ref"]
