"""ctypes wrapper of the Hopper SFS sweep (``csrc/sfs_sweep.cu``).

Counterpart of ``repro.kernels.sfs.kernel.sfs_sweep_pallas`` and
``repro.kernels.sfs.gpu.sfs_sweep_pallas_gpu``: one kernel covers both.
It takes the public layout of the sweep entry, ``(P, npad, d)`` points
and a ``(P, npad)`` bool mask, and writes a ``(P, wcap, d)`` window, a
``(P, wcap)`` bool mask and a ``(P,)`` int32 count.  The wrapper checks
every argument, allocates the outputs, launches on PyTorch's current
stream and raises if the launch fails.  It runs on CUDA tensors only:
given anything else it raises, and nothing runs in its place.

``sfs_sweep_cuda.launches`` counts the launches, so a run can show that
its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["sfs_sweep_cuda", "check_args", "D_MAX", "MAX_BLOCK"]

D_MAX = 12       # widest d the kernel is instantiated for
MAX_BLOCK = 512  # one thread per candidate row of a block


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, with every pointer and the stream passed as
    ``c_void_p`` (a plain int would be cut to 32 bits)."""
    lib = build.library("sfs_sweep")
    lib.sfs_sweep_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.sfs_sweep_launch.restype = ctypes.c_int
    lib.sfs_sweep_error_string.argtypes = [ctypes.c_int]
    lib.sfs_sweep_error_string.restype = ctypes.c_char_p
    return lib


def check_args(pts_s: torch.Tensor, mask_s: torch.Tensor, block: int,
               wcap: int) -> None:
    """Raise ``ValueError`` on any input the kernel does not take, apart
    from the device (checked by :func:`sfs_sweep_cuda` first)."""
    if pts_s.dtype != torch.float32 or mask_s.dtype != torch.bool:
        raise ValueError(f"sfs_sweep_cuda takes float32 points and a bool "
                         f"mask; got {pts_s.dtype} and {mask_s.dtype}")
    if pts_s.ndim != 3 or tuple(mask_s.shape) != tuple(pts_s.shape[:2]):
        raise ValueError(f"expected (P, npad, d)/(P, npad), got "
                         f"{tuple(pts_s.shape)}/{tuple(mask_s.shape)}")
    if not (pts_s.is_contiguous() and mask_s.is_contiguous()):
        raise ValueError("sfs_sweep_cuda needs contiguous inputs")
    p, npad, d = pts_s.shape
    if not 1 <= d <= D_MAX:
        raise ValueError(f"sfs_sweep_cuda takes 1 <= d <= {D_MAX}, got {d}")
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"sfs_sweep_cuda takes 1 <= block <= {MAX_BLOCK}, "
                         f"got {block}")
    if p < 1 or npad < 1 or npad % block != 0:
        raise ValueError(f"sfs_sweep_cuda needs P >= 1 and npad a positive "
                         f"multiple of block; got P={p}, npad={npad}, "
                         f"block={block}")
    if not 0 <= wcap < 2 ** 31:
        raise ValueError(f"wcap={wcap} out of range")


def sfs_sweep_cuda(pts_s: torch.Tensor, mask_s: torch.Tensor, *,
                   block: int, wcap: int, sentinel: float):
    """Launch the sweep on a (P, npad, d) sorted batch on the card.

    Returns ``(window (P, wcap, d) f32, wmask (P, wcap) bool,
    count (P,) int32)``; see ``repro_torch.kernels.sfs.ops`` for the
    contract."""
    if pts_s.device.type != "cuda" or mask_s.device != pts_s.device:
        raise ValueError(f"sfs_sweep_cuda needs both inputs on one CUDA "
                         f"device; got {pts_s.device} and {mask_s.device}")
    check_args(pts_s, mask_s, block, wcap)
    p, npad, d = pts_s.shape
    dev = pts_s.device
    window = torch.full((p, wcap, d), sentinel, dtype=torch.float32,
                        device=dev)
    wmask = torch.zeros((p, wcap), dtype=torch.bool, device=dev)
    count = torch.empty((p,), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sfs_sweep_launch(
            pts_s.data_ptr(), mask_s.data_ptr(), window.data_ptr(),
            wmask.data_ptr(), count.data_ptr(), p, npad, d, block, wcap,
            stream)
    if err != 0:
        msg = lib.sfs_sweep_error_string(err).decode()
        raise RuntimeError(f"sfs_sweep kernel launch failed: {msg} ({err})")
    sfs_sweep_cuda.launches += 1
    return window, wmask, count


sfs_sweep_cuda.launches = 0
