"""ctypes wrapper of the Hopper SFS sweep (``csrc/sfs_sweep.cu``).

Counterpart of ``repro.kernels.sfs.kernel.sfs_sweep_pallas`` and
``repro.kernels.sfs.gpu.sfs_sweep_pallas_gpu``: one kernel covers both.
It takes the public layout of the sweep entry, ``(P, npad, d)`` points
and a ``(P, npad)`` bool mask, and writes a ``(P, wcap, d)`` window, a
``(P, wcap)`` bool mask and a ``(P,)`` int32 count.  The wrapper checks
every argument, allocates the outputs and the scratch, launches on
PyTorch's current stream and raises if a launch fails.  It runs on CUDA
tensors only: given anything else it raises, and nothing runs in its
place.

One call launches up to three grids, with no host synchronisation
between them (the source's header says why the schedule is exact):

  A. the sequential sweep of the first :func:`prefix_rows` rows of every
     partition (K = 16 blocks at the default block of 256), one CTA per
     partition;
  B. a filter of every later row against the prefix window, on a grid
     of (row tiles x partitions), one grid for each 65,535 partitions;
  C. the sequential sweep of the rows B left alive.

When the prefix covers a partition, A is the whole sweep and one grid
runs.  ``sfs_sweep_cuda.launches`` counts entry calls, not grids, so a
run can show that its main path went through the kernel.
:func:`sweep_stages` runs the same grids with CUDA events between them,
for measurement only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["sfs_sweep_cuda", "sweep_stages", "check_args",
           "sweep_smem_bytes", "prefix_rows", "D_MAX", "MAX_BLOCK",
           "MAX_PARTS", "PREFIX_ROWS", "SMEM_LIMIT"]

D_MAX = 12           # widest d the kernel is instantiated for
MAX_BLOCK = 512      # one thread per candidate row of a block
MAX_PARTS = 2 ** 31 - 1  # A and C take the partitions on x; B on y, in
#                          slices of 65,535
PREFIX_ROWS = 4096   # rows stage A sweeps, rounded up to whole blocks
SMEM_LIMIT = 232_448  # shared memory one CTA may take on sm_90

# the constants of csrc/sfs_sweep.cu that its shared memory follows
_SEQ_THREADS = 512
_QUEUE_CAP = _SEQ_THREADS * 16 + _SEQ_THREADS   # kQueueCap
_RESIDENT_BYTES = 131_072                       # kResidentBytes
_FILTER_TILE_BYTES = 32_768                     # kFilterTileBytes


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, with every pointer and the stream passed as
    ``c_void_p`` (a plain int would be cut to 32 bits)."""
    lib = build.library("sfs_sweep")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sfs_sweep_seq_launch.argtypes = (
        [ptr, ptr, i64, i32, i32] + [ptr] * 5 + [i32] * 5 + [ptr])
    lib.sfs_sweep_seq_launch.restype = ctypes.c_int
    lib.sfs_sweep_filter_launch.argtypes = (
        [ptr] * 5 + [i64, ptr] + [i32] * 5 + [ptr])
    lib.sfs_sweep_filter_launch.restype = ctypes.c_int
    lib.sfs_sweep_smem_bytes.argtypes = [i32] * 5
    lib.sfs_sweep_smem_bytes.restype = i64
    lib.sfs_sweep_error_string.argtypes = [ctypes.c_int]
    lib.sfs_sweep_error_string.restype = ctypes.c_char_p
    return lib


def prefix_rows(npad: int, block: int, rows: int = PREFIX_ROWS) -> int:
    """The rows stage A sweeps: ``rows`` rounded up to whole blocks, at
    most ``npad``."""
    return min(npad, -(-rows // block) * block)


def sweep_smem_bytes(d: int, block: int,
                     wcap: int = 2 ** 31 - 1) -> dict[str, int]:
    """The footprint law: the shared memory (all of it dynamic) that one
    CTA of each stage takes, by stage.

    Stages A and C (the sequential sweep): the candidate block, the row
    queue (a chunk of flags plus a partial block), the warp sums, one
    pending flag per thread and the resident window rows.  Stage B: one
    tile of the prefix window, at most the prefix's ``min(prefix rows,
    wcap)`` rows.  Counterpart of
    ``repro.kernels.sfs.kernel.sweep_vmem_bytes``; the kernel's
    ``sfs_sweep_smem_bytes`` computes the same numbers."""
    seq = (4 * d * block + 4 * _QUEUE_CAP + 4 * 32 + 4 * _SEQ_THREADS
           + 4 * d * (_RESIDENT_BYTES // (4 * d)))
    tile = min(_FILTER_TILE_BYTES // (4 * d), prefix_rows(2 ** 31 - 1, block),
               wcap)
    return {"prefix": seq, "filter": 4 * d * tile, "survivors": seq}


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
    p, npad, d = pts_s.shape
    if not 1 <= d <= D_MAX:
        raise ValueError(f"sfs_sweep_cuda takes 1 <= d <= {D_MAX}, got {d}")
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"sfs_sweep_cuda takes 1 <= block <= {MAX_BLOCK}, "
                         f"got {block}")
    if not 1 <= p <= MAX_PARTS or npad < 1 or npad % block != 0:
        raise ValueError(f"sfs_sweep_cuda needs 1 <= P <= {MAX_PARTS} and "
                         f"npad a positive multiple of block; got P={p}, "
                         f"npad={npad}, block={block}")
    if not (pts_s.is_contiguous() and mask_s.is_contiguous()):
        raise ValueError("sfs_sweep_cuda needs contiguous inputs")
    if npad >= 2 ** 31 or not 0 <= wcap < 2 ** 31:
        raise ValueError(f"npad={npad} or wcap={wcap} out of range")
    smem = sweep_smem_bytes(d, block, wcap)
    over = {k: v for k, v in smem.items() if v > SMEM_LIMIT}
    if over:
        raise ValueError(f"sfs_sweep_cuda would take {over} bytes of shared "
                         f"memory per CTA, above {SMEM_LIMIT}")


def _launch(pts_s, mask_s, block, wcap, sentinel, prefix, events=None):
    """Allocate the outputs and scratch and launch the stages on the
    current stream.  ``events``, when given, is a list of four CUDA
    events recorded before A, B and C and after C.  Returns
    ``(window, wmask, count, c_a, survivors)``; the last two are None
    when stage A covers the sweep."""
    p, npad, d = pts_s.shape
    dev = pts_s.device
    window = torch.full((p, wcap, d), sentinel, dtype=torch.float32,
                        device=dev)
    wmask = torch.zeros((p, wcap), dtype=torch.bool, device=dev)
    count = torch.empty((p,), dtype=torch.int32, device=dev)
    r0 = prefix_rows(npad, block, prefix)
    c_a = surv = None
    if r0 < npad:
        stride = -(-(npad - r0) // 16) * 16   # 16-byte aligned flag rows
        alive = torch.empty((p, stride), dtype=torch.uint8, device=dev)
        c_a = torch.empty((p,), dtype=torch.int32, device=dev)
        surv = torch.zeros((p,), dtype=torch.int32, device=dev)
    lib = _lib()
    pts, mask = pts_s.data_ptr(), mask_s.data_ptr()
    win, wm = window.data_ptr(), wmask.data_ptr()

    def check(err):
        if err != 0:
            msg = lib.sfs_sweep_error_string(err).decode()
            raise RuntimeError(f"sfs_sweep kernel launch failed: {msg} "
                               f"({err})")

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        s = stream.cuda_stream

        def mark(i):
            if events is not None:
                events[i].record(stream)

        mark(0)
        check(lib.sfs_sweep_seq_launch(
            pts, mask, npad, 0, r0, win, wm, None, None,
            (count if c_a is None else c_a).data_ptr(), p, npad, d, block,
            wcap, s))
        if c_a is not None:
            mark(1)
            check(lib.sfs_sweep_filter_launch(
                pts, mask, win, c_a.data_ptr(), alive.data_ptr(), stride,
                surv.data_ptr(), p, npad, d, r0, wcap, s))
            mark(2)
            check(lib.sfs_sweep_seq_launch(
                pts, alive.data_ptr(), stride, r0, npad, win, wm,
                c_a.data_ptr(), surv.data_ptr(), count.data_ptr(), p, npad,
                d, block, wcap, s))
        mark(3)
    return window, wmask, count, c_a, surv


def _check_device(pts_s, mask_s):
    if pts_s.device.type != "cuda" or mask_s.device != pts_s.device:
        raise ValueError(f"sfs_sweep_cuda needs both inputs on one CUDA "
                         f"device; got {pts_s.device} and {mask_s.device}")


def sfs_sweep_cuda(pts_s: torch.Tensor, mask_s: torch.Tensor, *,
                   block: int, wcap: int, sentinel: float):
    """Launch the sweep on a (P, npad, d) sorted batch on the card.

    Returns ``(window (P, wcap, d) f32, wmask (P, wcap) bool,
    count (P,) int32)``; see ``repro_torch.kernels.sfs.ops`` for the
    contract."""
    _check_device(pts_s, mask_s)
    check_args(pts_s, mask_s, block, wcap)
    window, wmask, count, _, _ = _launch(pts_s, mask_s, block, wcap,
                                         sentinel, PREFIX_ROWS)
    sfs_sweep_cuda.launches += 1
    return window, wmask, count


sfs_sweep_cuda.launches = 0


def sweep_stages(pts_s: torch.Tensor, mask_s: torch.Tensor, *, block: int,
                 wcap: int, sentinel: float, prefix: int = PREFIX_ROWS):
    """The sweep with CUDA events around its grids, for measurement: it
    synchronises, and its launches do not count on
    :func:`sfs_sweep_cuda`.  ``prefix`` sets stage A's rows.

    Returns ``(outputs, info)``: the three outputs of the sweep, and per
    partition stage A's count ``c_a``, the rows B left alive
    ``survivors`` and whether C ``packed`` them (None where A covered
    the sweep), beside the ms of each grid (``a_ms``, ``b_ms``,
    ``c_ms``; 0.0 for a grid that did not run) and ``prefix_rows``."""
    _check_device(pts_s, mask_s)
    check_args(pts_s, mask_s, block, wcap)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    window, wmask, count, c_a, surv = _launch(pts_s, mask_s, block, wcap,
                                              sentinel, prefix, events)
    events[3].synchronize()
    p, npad, _ = pts_s.shape
    info = {"prefix_rows": prefix_rows(npad, block, prefix),
            "a_ms": events[0].elapsed_time(events[3]), "b_ms": 0.0,
            "c_ms": 0.0, "c_a": count.tolist(), "survivors": [0] * p,
            "packed": [None] * p}
    if c_a is not None:
        info.update(
            a_ms=events[0].elapsed_time(events[1]),
            b_ms=events[1].elapsed_time(events[2]),
            c_ms=events[2].elapsed_time(events[3]), c_a=c_a.tolist(),
            survivors=surv.tolist(),
            packed=[a + s <= wcap for a, s in zip(c_a.tolist(),
                                                  surv.tolist())])
    return (window, wmask, count), info


def kernel_smem_bytes(d: int, block: int, wcap: int) -> dict[str, int]:
    """The shared memory the built kernel computes for each stage (its
    ``sfs_sweep_smem_bytes``), to hold :func:`sweep_smem_bytes` against
    on the card's host."""
    lib = _lib()
    r0 = prefix_rows(2 ** 31 - 1, block)
    seq = lib.sfs_sweep_smem_bytes(0, d, block, r0, wcap)
    return {"prefix": seq,
            "filter": lib.sfs_sweep_smem_bytes(1, d, block, r0, wcap),
            "survivors": seq}
