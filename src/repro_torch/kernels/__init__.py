"""Compute kernels of the port, behind the backend registry.

``repro_torch.kernels.sfs.ops.sfs_sweep`` is the fused SFS sweep, the one
kernel family of the skyline pipeline ported so far: a hand-written CUDA
kernel for Hopper (``sfs/csrc/sfs_sweep.cu``, built by ``build.py`` at
first use), its plain PyTorch version, and the per-pair oracle.
``backend.py`` picks among them and holds the device rule.
"""
