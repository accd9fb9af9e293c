"""The fused SFS sweep: :func:`sfs_sweep` is its one entry.

Counterpart of ``repro.kernels.sfs``: callers outside the kernels
package import the entry from here, never a submodule (``kernel``,
``ops``, ``ref``; lint rule R3 of ``repro_torch.analysis``).  The entry
is exported lazily (PEP 562): ``ops`` imports the backend registry,
which imports ``kernel`` for its limits, so an eager import here would
close an import cycle through this package.
"""

__all__ = ["sfs_sweep"]


def __getattr__(name):
    if name == "sfs_sweep":
        from repro_torch.kernels.sfs.ops import sfs_sweep
        return sfs_sweep
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
