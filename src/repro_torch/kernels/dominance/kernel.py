"""ctypes wrapper of the Hopper dominance kernel (``csrc/dominated_mask.cu``).

Counterpart of ``repro.kernels.dominance.kernel.dominated_mask_pallas``
and ``repro.kernels.dominance.gpu.dominated_mask_pallas_gpu``: one kernel
covers both.  It takes the row-major layout of the dominance entry with
a leading batch axis: ``(B, C, d)`` f32 candidates, ``(B, R, d)`` f32
references and a ``(B, R)`` bool mask, where references and mask may be
broadcast over the batch (batch stride 0, as ``expand`` gives them), and
writes a ``(B, C)`` bool flag.  The wrapper checks every argument,
allocates the output and the scratch, launches on PyTorch's current
stream and raises if the launch fails.  It runs on CUDA tensors only:
given anything else it raises, and nothing runs in its place.

One call launches up to two grids, with no host synchronisation between
them (the source's header says why the result is exact):

  1. when R is longer than one tile (:func:`compacts`, decided from
     shapes alone), the valid references of each batch are compacted, in
     order, into a dense scratch buffer stored by coordinate, with their
     original indices and the batch's count; references and mask shared
     by the whole batch are compacted once;
  2. the walk of every candidate block over those rows (or over the
     references themselves when they fit one tile), ending at the
     batch's own count.

``dominated_mask_cuda.launches`` counts entry calls, not grids, so a run
can show that its main path went through the kernel.
:func:`dominance_stages` runs the same grids with CUDA events around
them, for measurement only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["dominated_mask_cuda", "dominance_stages", "check_args",
           "dominance_smem_bytes", "tile_rows", "compacts", "scratch_words",
           "D_MAX", "MAX_BATCH", "TILE_BYTES", "SMEM_LIMIT"]

D_MAX = 12            # widest d the kernel is instantiated for
MAX_BATCH = 2 ** 31 - 1  # grid 1 takes the batches on y in slices of
#                          65,535; grid 2's 1-D grid holds every block
TILE_BYTES = 16_384   # coordinates of one tile (kTileBytes)
SMEM_LIMIT = 232_448  # shared memory one CTA may take on sm_90

# the constants of csrc/dominated_mask.cu that its schedule and shared
# memory follow
_STAGES = 2            # kStages
_THREADS = 256         # kThreads: grid 1's CTA
_LANE_ROWS = 32        # kLaneRows
_LANE_UNROLL = 4       # kLaneUnroll
_WARP_UNROLL = 8       # kWarpUnroll
_COMPACT_PER = 16      # kCompactPer: reference rows per compact thread
# the walk's CTA, by form: (threads, lanes of each warp that hold a
# candidate), a block of 128 candidates either way (kDirectThreads,
# kDirectHeld, kRingThreads, kRingHeld)
_WALK_SHAPE = {"direct": (128, 32), "ring": (256, 16)}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, with every pointer and the stream passed as
    ``c_void_p`` (a plain int would be cut to 32 bits)."""
    lib = build.library("dominated_mask")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dominated_mask_launch.argtypes = (
        [ptr] * 5 + [i32] * 4 + [i64] * 2 + [i32] + [ptr] * 3)
    lib.dominated_mask_launch.restype = ctypes.c_int
    lib.dominated_mask_smem_bytes.argtypes = [i32] * 2
    lib.dominated_mask_smem_bytes.restype = i64
    lib.dominated_mask_error_string.argtypes = [ctypes.c_int]
    lib.dominated_mask_error_string.restype = ctypes.c_char_p
    return lib


def tile_rows(d: int) -> int:
    """Reference rows of one tile: ``TILE_BYTES`` of coordinates, in whole
    32-row steps (``tile_rows`` in the source)."""
    return TILE_BYTES // (4 * d) // 32 * 32


def compacts(r: int, d: int) -> bool:
    """Whether a call with ``r`` references runs grid 1 (the compaction):
    when they are longer than one tile."""
    return r > tile_rows(d)


def scratch_words(b: int, r: int, d: int, shared: bool) -> int:
    """32-bit words of the compaction's scratch: per compacted batch
    (one when references and mask are shared by the batch), ``d`` rows of
    coordinates and one of original indices, ``Rs = ceil4(r)`` long;
    then one count per compacted batch."""
    bc = 1 if shared else b
    return bc * (d + 1) * (-(-r // 4) * 4) + bc


def dominance_smem_bytes(d: int, r: int | None = None) -> dict[str, int]:
    """The footprint law: the dynamic shared memory of one walk CTA, by
    form, each staged row ``d + 1`` words (the coordinates and, under
    lower_tri, the original index).  ``ring``: when grid 1 compacts the
    references, a head of ``_LANE_ROWS`` rows and ``_STAGES`` tiles;
    ``direct``: the references themselves, ``ceil32(r)`` rows, at most
    one tile (the most, when ``r`` is None).
    Grid 1 takes static shared memory only.  Counterpart of
    ``repro.kernels.dominance.kernel.dominance_vmem_bytes``; the kernel's
    ``dominated_mask_smem_bytes`` computes the same numbers."""
    t = tile_rows(d)
    rows = t if r is None else min(t, -(-r // 32) * 32)
    return {"ring": 4 * (d + 1) * (_LANE_ROWS + _STAGES * t),
            "direct": 4 * (d + 1) * rows}


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
    if not 1 <= d <= D_MAX:
        raise ValueError(f"dominated_mask_cuda takes 1 <= d <= {D_MAX}, "
                         f"got {d}")
    if c >= 2 ** 31 or r >= 2 ** 31:
        raise ValueError(f"C={c} or R={r} out of range")
    threads, held = _WALK_SHAPE["ring" if compacts(r, d) else "direct"]
    blocks = -(-c // (threads // 32 * held)) * b
    if not 1 <= b <= MAX_BATCH or blocks >= 2 ** 31:
        raise ValueError(f"dominated_mask_cuda takes 1 <= B <= {MAX_BATCH} "
                         f"and fewer than 2^31 candidate blocks; got B={b}, "
                         f"{blocks} blocks")
    if not cands.is_contiguous():
        raise ValueError("dominated_mask_cuda needs contiguous candidates")
    if r > 0 and ((d > 1 and refs.stride(1) != d) or refs.stride(2) != 1
                  or ref_mask.stride(1) != 1):
        raise ValueError("dominated_mask_cuda needs contiguous reference "
                         "rows and mask (any batch stride)")
    smem = dominance_smem_bytes(d, r)
    form = "ring" if compacts(r, d) else "direct"
    if smem[form] > SMEM_LIMIT:
        raise ValueError(f"dominated_mask_cuda would take {smem[form]} bytes "
                         f"of shared memory per CTA, above {SMEM_LIMIT}")


def _check_device(cands, refs, ref_mask):
    if (cands.device.type != "cuda" or refs.device != cands.device
            or ref_mask.device != cands.device):
        raise ValueError(f"dominated_mask_cuda needs all inputs on one CUDA "
                         f"device; got {cands.device}, {refs.device} and "
                         f"{ref_mask.device}")


def _launch(cands, refs, ref_mask, lower_tri, events=(None, None)):
    """Allocate the output and scratch and launch the grids on the
    current stream.  ``events``, when given, two recorded CUDA events,
    recorded again before grid 1 and between the grids.  Returns
    ``(out, scratch)``; ``scratch`` is None without grid 1."""
    b, c, d = cands.shape
    r = refs.shape[1]
    dev = cands.device
    out = torch.empty((b, c), dtype=torch.bool, device=dev)
    ref_bs = refs.stride(0) if r else 0
    mask_bs = ref_mask.stride(0) if r else 0
    scratch = None
    if compacts(r, d):
        scratch = torch.empty(
            (scratch_words(b, r, d, ref_bs == 0 and mask_bs == 0),),
            dtype=torch.int32, device=dev)
    lib = _lib()
    ev = [None if e is None else e.cuda_event for e in events]
    args = (cands.data_ptr(), refs.data_ptr(), ref_mask.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            b, c, r, d, ref_bs, mask_bs, int(lower_tri), *ev,
            torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):   # the launch goes to the current device
        err = lib.dominated_mask_launch(*args)
    if err != 0:
        msg = lib.dominated_mask_error_string(err).decode()
        raise RuntimeError(f"dominated_mask kernel launch failed: {msg} "
                           f"({err})")
    return out, scratch


def dominated_mask_cuda(cands: torch.Tensor, refs: torch.Tensor,
                        ref_mask: torch.Tensor, *,
                        lower_tri: bool = False) -> torch.Tensor:
    """Launch the dominance test on a batch on the card.

    Returns the ``(B, C)`` bool flag; see
    ``repro_torch.kernels.dominance.ops`` for the contract."""
    _check_device(cands, refs, ref_mask)
    check_args(cands, refs, ref_mask)
    if cands.shape[1] == 0:
        return torch.empty(cands.shape[:2], dtype=torch.bool,
                           device=cands.device)
    out, _ = _launch(cands, refs, ref_mask, lower_tri)
    dominated_mask_cuda.launches += 1
    return out


dominated_mask_cuda.launches = 0


def dominance_stages(cands: torch.Tensor, refs: torch.Tensor,
                     ref_mask: torch.Tensor, *, lower_tri: bool = False):
    """The dominance test with CUDA events around its grids, for
    measurement: it synchronises, and its launches do not count on
    :func:`dominated_mask_cuda`.

    Returns ``(out, info)``: the ``(B, C)`` flag, and the ms of each grid
    (``compact_ms``, 0.0 when grid 1 did not run, and ``walk_ms``),
    whether grid 1 ran (``compacted``), the valid reference rows of each
    compacted batch as the kernel counted them (``valid_rows``; from the
    mask on the direct path) and ``tile_rows``."""
    _check_device(cands, refs, ref_mask)
    check_args(cands, refs, ref_mask)
    b, c, d = cands.shape
    r = refs.shape[1]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for e in events[:2]:             # the CUDA events are made at a record
        e.record()
    out, scratch = _launch(cands, refs, ref_mask, lower_tri, events[:2])
    events[2].record()
    events[2].synchronize()
    if scratch is not None:        # the counts end the scratch
        bc = 1 if refs.stride(0) == 0 and ref_mask.stride(0) == 0 else b
        valid = scratch[scratch.shape[0] - bc:].tolist()
    else:
        valid = ref_mask.sum(dim=1).tolist() if r else [0] * b
    info = {"compact_ms": (events[0].elapsed_time(events[1])
                           if scratch is not None else 0.0),
            "walk_ms": events[1].elapsed_time(events[2]),
            "compacted": scratch is not None, "valid_rows": valid,
            "tile_rows": tile_rows(d)}
    return out, info


def kernel_smem_bytes(d: int, r: int | None = None) -> dict[str, int]:
    """The shared memory the built kernel computes for each walk form
    (its ``dominated_mask_smem_bytes``), to hold
    :func:`dominance_smem_bytes` against on the card's host."""
    lib = _lib()
    t = tile_rows(d)
    return {"ring": lib.dominated_mask_smem_bytes(d, t + 1),
            "direct": lib.dominated_mask_smem_bytes(
                d, t if r is None else min(r, t))}
