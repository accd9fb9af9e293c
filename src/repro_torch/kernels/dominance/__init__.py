from repro_torch.kernels.dominance.ref import (dominance_matrix_ref,
                                              dominated_mask_ref)

__all__ = ["dominance_matrix_ref", "dominated_mask_ref"]
