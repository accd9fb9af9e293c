"""PyTorch and CUDA port of the parallel skyline system.

A second package beside the JAX reference ``repro``, module for module:
``repro_torch.core.api.parallel_skyline`` and ``skyline`` run the
paper's pipeline, and the fused SFS sweep under them is a hand-written
CUDA kernel for Hopper (``kernels/sfs/csrc/sfs_sweep.cu``).  The package
imports torch and numpy, never JAX and nothing of ``repro``.  Entry
points run on the card unless the caller passes ``device="cpu"``.
"""
