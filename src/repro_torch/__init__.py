"""PyTorch and CUDA port of the parallel skyline system.

A second package beside the JAX reference ``repro``, module for module:
``repro_torch.core.api.parallel_skyline`` and ``skyline`` run the
paper's pipeline, ``init_state`` / ``insert_chunk`` / ``finalize`` keep
a running skyline, and the two kernels under them are written by hand
for Hopper: the fused SFS sweep (``kernels/sfs/csrc/sfs_sweep.cu``) and
the pairwise dominance test
(``kernels/dominance/csrc/dominated_mask.cu``).  The package
imports torch and numpy, never JAX and nothing of ``repro``.  Entry
points run on the card unless the caller passes ``device="cpu"``.
"""
