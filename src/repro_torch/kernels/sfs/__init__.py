"""The fused SFS sweep: ``ops.sfs_sweep`` is its one entry.

Submodules are imported by their users (``ops``, ``kernel``, ``ref``), so
that importing the backend registry, which reads the kernel's limits,
does not import the entry that depends on the registry.
"""
