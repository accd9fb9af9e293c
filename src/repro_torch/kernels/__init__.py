"""Compute kernels of the port, behind the backend registry.

Two kernel families, each a hand-written CUDA kernel for Hopper (built
by ``build.py`` at first use) beside its plain PyTorch version:

* ``repro_torch.kernels.sfs.sfs_sweep``, the fused SFS sweep
  (``sfs/csrc/sfs_sweep.cu``), with the per-pair sweep oracle;
* ``repro_torch.kernels.dominance.dominated_mask``, the pairwise
  dominance test (``dominance/csrc/dominated_mask.cu``).

Code outside this package imports those entries from the family's
package and never its submodules.  ``backend.py`` picks among the
implementations and holds the device rule.
"""
