"""Kernel-backend registry and the device rule.

Counterpart of ``repro.kernels.backend``.  One immutable
:class:`KernelSpec` names the implementation of each kernel family,
resolved from the ``SkyConfig.impl`` string:

  ``'cuda'``     the hand-written Hopper kernel (``kernels/sfs/csrc``
                 and ``kernels/dominance/csrc``), for tensors on the card
                 only;
  ``'torch'``    the plain PyTorch version of the same function, on any
                 device (the CPU tests run it; on the card it runs only
                 when a caller asks for it by name);
  ``'perpair'``  the per-pair oracle, on any device;
  ``'auto'``     ``'cuda'`` for a tensor on the card and ``'torch'`` for
                 a tensor on the CPU.  The choice follows where the data
                 is, and the data is where the caller put it.

The device rule of the public entry points lives here too
(:func:`resolve_device`): they run on the card unless the caller passes
``device="cpu"``, and without a card they raise instead of moving to the
CPU.  So do the three hooks of the program verifier
(``repro_torch.analysis.verifier``): :func:`kernel_call`, through which
each family's entry runs its implementation, :func:`collective_call`,
through which the mesh's collectives run (``repro_torch.launch.mesh``),
and :func:`smem_estimate`, the kernels' shared-memory laws for one
configuration.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils import _python_dispatch

from repro_torch.kernels.dominance import kernel as _dom_kernel
from repro_torch.kernels.sfs import kernel as _sfs_kernel

__all__ = ["KernelSpec", "available_backends", "resolve_spec",
           "register_backend", "impl_max_d", "resolve_device",
           "kernel_call", "collective_call", "smem_estimate"]

_SWEEP_IMPLS = ("cuda", "torch", "perpair")
_DOMINANCE_IMPLS = ("cuda", "torch")


def impl_max_d(impl: str) -> int | None:
    """Widest ``d`` the per-family implementation string takes: None,
    unbounded, for every one.  Past their narrow instantiations the CUDA
    kernels take d at run time, and their footprint laws bound what fits
    (their check_args say so), as the reference's GPU kernels pad d."""
    return None


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Resolved kernel choices for one pipeline configuration.

    Attributes:
      name: registry key (what ``SkyConfig.impl`` held, after 'auto').
      sweep: SFS sweep implementation.
      dominance: pairwise dominance implementation.
      max_d: widest attribute dimension the implementations take
        (None = unbounded, as for every built-in backend).
    """
    name: str
    sweep: str
    dominance: str
    max_d: int | None = None

    def __post_init__(self):
        if self.sweep not in _SWEEP_IMPLS:
            raise ValueError(f"unknown sweep impl {self.sweep!r}; "
                             f"valid: {_SWEEP_IMPLS}")
        if self.dominance not in _DOMINANCE_IMPLS:
            raise ValueError(f"unknown dominance impl {self.dominance!r}; "
                             f"valid: {_DOMINANCE_IMPLS}")


_REGISTRY: dict[str, KernelSpec] = {
    "cuda": KernelSpec("cuda", sweep="cuda", dominance="cuda"),
    "torch": KernelSpec("torch", sweep="torch", dominance="torch"),
    "perpair": KernelSpec("perpair", sweep="perpair", dominance="torch"),
}


def register_backend(spec: KernelSpec, *, overwrite: bool = False) -> None:
    """Add a backend under ``spec.name`` (used as the ``impl`` string)."""
    if spec.name == "auto":
        raise ValueError("'auto' is reserved for runtime resolution")
    if spec.name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec


def available_backends() -> tuple[str, ...]:
    """Registered backend names (excluding the 'auto' alias)."""
    return tuple(sorted(_REGISTRY))


def resolve_spec(impl: str | KernelSpec, device: torch.device) -> KernelSpec:
    """``SkyConfig.impl`` -> :class:`KernelSpec` for data on ``device``.

    ``'auto'`` picks the kernel for data on the card and the plain
    version for data on the CPU.  ``'cuda'`` for data elsewhere than on
    the card raises: the kernel never runs on the CPU, and nothing runs
    in its place."""
    device = torch.device(device)
    if isinstance(impl, KernelSpec):
        spec = impl
    else:
        if impl == "auto":
            impl = "cuda" if device.type == "cuda" else "torch"
        try:
            spec = _REGISTRY[impl]
        except KeyError:
            raise ValueError(
                f"unknown kernel backend {impl!r}; registered: "
                f"{', '.join(sorted(_REGISTRY))} (or 'auto')") from None
    if "cuda" in (spec.sweep, spec.dominance) and device.type != "cuda":
        raise ValueError(f"impl {spec.name!r} runs on CUDA tensors only; "
                         f"got data on {device}")
    return spec


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    asks for another.  Raises ``RuntimeError`` when that is the card and
    CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def kernel_call(family: str, impl: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``: one call of kernel family ``family``
    (``'sfs_sweep'`` or ``'dominated_mask'``) by implementation ``impl``.

    Each family's entry runs its implementation through here.  Under a
    dispatch mode that records kernel calls (it has a ``record_kernel``
    method: the verifier's census), the call is handed to the mode,
    which counts it as one operation of the program, as the kernel is
    one launch on the card, and does not count the operations inside.
    Otherwise this is the call itself."""
    mode = _python_dispatch._get_current_dispatch_mode()
    record = getattr(mode, "record_kernel", None)
    if record is None:
        return fn(*args, **kwargs)
    return record(family, impl, fn, args, kwargs)


def collective_call(kind: str, group: str, fn, x, *, counted: bool = True):
    """``fn(x)``: one collective of kind ``kind`` (``'all_gather'``,
    ``'ppermute'``, ``'broadcast'``, ``'psum'``) over the mesh group
    ``group`` (``'workers'`` or ``'queries'``).

    Under a dispatch mode that records collectives (it has a
    ``record_collective`` method: the verifier's census) the call is
    handed to the mode, which counts it as one operation of the program
    by kind and group, with the elements of its operand and result, and
    does not count the operations inside.  ``counted=False`` marks the
    assembly of a sharded batch outside the program, which the census
    reports apart.  Otherwise this is the call itself."""
    mode = _python_dispatch._get_current_dispatch_mode()
    record = getattr(mode, "record_collective", None)
    if record is None:
        return fn(x)
    return record(kind, group, fn, x, counted)


def smem_estimate(d: int, block: int, wcap: int) -> dict[str, int]:
    """The most shared memory one CTA of each kernel family takes at
    this configuration, from the kernels' footprint laws
    (``sfs.kernel.sweep_smem_bytes``, ``dominance.kernel.
    dominance_smem_bytes``): ``{"sweep": bytes, "dominance": bytes}``.
    Counterpart of ``repro.kernels.backend.vmem_estimate``."""
    return {"sweep": max(_sfs_kernel.sweep_smem_bytes(d, block,
                                                      wcap).values()),
            "dominance": max(_dom_kernel.dominance_smem_bytes(d).values())}
