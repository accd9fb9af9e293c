"""ctypes wrapper of the Hopper dominance kernel (``csrc/dominated_mask.cu``).

Counterpart of ``repro.kernels.dominance.kernel.dominated_mask_pallas``
and ``repro.kernels.dominance.gpu.dominated_mask_pallas_gpu``: one kernel
covers both.  It takes the row-major layout of the dominance entry with
a leading batch axis: ``(B, C, d)`` f32 candidates, ``(B, R, d)`` f32
references and a ``(B, R)`` bool mask, where references and mask may be
broadcast over the batch (batch stride 0, as ``expand`` gives them), and
writes a ``(B, C)`` bool flag.  The wrapper checks every argument,
allocates the output, launches on PyTorch's current stream and raises if
the launch fails.  It runs on CUDA tensors only: given anything else it
raises, and nothing runs in its place.

``dominated_mask_cuda.launches`` counts the launches, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["dominated_mask_cuda", "check_args", "D_MAX", "MAX_BATCH"]

D_MAX = 12          # widest d the kernel is instantiated for
MAX_BATCH = 65535   # the batch is the grid's y dimension


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, with every pointer and the stream passed as
    ``c_void_p`` (a plain int would be cut to 32 bits)."""
    lib = build.library("dominated_mask")
    lib.dominated_mask_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
    lib.dominated_mask_launch.restype = ctypes.c_int
    lib.dominated_mask_error_string.argtypes = [ctypes.c_int]
    lib.dominated_mask_error_string.restype = ctypes.c_char_p
    return lib


def check_args(cands: torch.Tensor, refs: torch.Tensor,
               ref_mask: torch.Tensor) -> None:
    """Raise ``ValueError`` on any input the kernel does not take, apart
    from the device (checked by :func:`dominated_mask_cuda` first)."""
    if (cands.dtype != torch.float32 or refs.dtype != torch.float32
            or ref_mask.dtype != torch.bool):
        raise ValueError(f"dominated_mask_cuda takes float32 points and a "
                         f"bool mask; got {cands.dtype}, {refs.dtype} and "
                         f"{ref_mask.dtype}")
    if cands.ndim != 3 or refs.ndim != 3 or ref_mask.ndim != 2:
        raise ValueError(f"expected (B, C, d)/(B, R, d)/(B, R), got "
                         f"{tuple(cands.shape)}/{tuple(refs.shape)}/"
                         f"{tuple(ref_mask.shape)}")
    b, c, d = cands.shape
    r = refs.shape[1]
    if refs.shape != (b, r, d) or ref_mask.shape != (b, r):
        raise ValueError(f"shapes disagree: {tuple(cands.shape)}/"
                         f"{tuple(refs.shape)}/{tuple(ref_mask.shape)}")
    if not cands.is_contiguous():
        raise ValueError("dominated_mask_cuda needs contiguous candidates")
    if r > 0 and ((d > 1 and refs.stride(1) != d) or refs.stride(2) != 1
                  or ref_mask.stride(1) != 1):
        raise ValueError("dominated_mask_cuda needs contiguous reference "
                         "rows and mask (any batch stride)")
    if not 1 <= d <= D_MAX:
        raise ValueError(f"dominated_mask_cuda takes 1 <= d <= {D_MAX}, "
                         f"got {d}")
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"dominated_mask_cuda takes 1 <= B <= {MAX_BATCH}, "
                         f"got {b}")
    if c >= 2 ** 31 or r >= 2 ** 31:
        raise ValueError(f"C={c} or R={r} out of range")


def dominated_mask_cuda(cands: torch.Tensor, refs: torch.Tensor,
                        ref_mask: torch.Tensor, *,
                        lower_tri: bool = False) -> torch.Tensor:
    """Launch the dominance test on a batch on the card.

    Returns the ``(B, C)`` bool flag; see
    ``repro_torch.kernels.dominance.ops`` for the contract."""
    if (cands.device.type != "cuda" or refs.device != cands.device
            or ref_mask.device != cands.device):
        raise ValueError(f"dominated_mask_cuda needs all inputs on one CUDA "
                         f"device; got {cands.device}, {refs.device} and "
                         f"{ref_mask.device}")
    check_args(cands, refs, ref_mask)
    b, c, d = cands.shape
    r = refs.shape[1]
    out = torch.empty((b, c), dtype=torch.bool, device=cands.device)
    if c == 0:
        return out
    lib = _lib()
    with torch.cuda.device(cands.device):
        stream = torch.cuda.current_stream(cands.device).cuda_stream
        err = lib.dominated_mask_launch(
            cands.data_ptr(), refs.data_ptr(), ref_mask.data_ptr(),
            out.data_ptr(), b, c, r, d, refs.stride(0) if r else 0,
            ref_mask.stride(0) if r else 0, int(lower_tri), stream)
    if err != 0:
        msg = lib.dominated_mask_error_string(err).decode()
        raise RuntimeError(f"dominated_mask kernel launch failed: {msg} "
                           f"({err})")
    dominated_mask_cuda.launches += 1
    return out


dominated_mask_cuda.launches = 0
