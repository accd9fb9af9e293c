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
     partition (K = 16 blocks at the default block of 256; past
     :data:`NARROW_D`, :func:`entry_prefix`), one CTA per partition;
  B. a filter of every later row against the prefix window, on a grid
     of (row tiles x partitions), one grid for each 65,535 partitions;
  C. the sequential sweep of the rows B left alive.

When the prefix covers a partition, A is the whole sweep and one grid
runs.  Every d up to :data:`NARROW_D` runs the kernel's instantiation for
that d; any wider d runs its wide variant, which takes d at run time
(the source's header says how).  Past :data:`NARROW_D` three more grids
run between B and C and take C's packed branch across the card: R ranks
B's survivors into a coordinate-major scratch buffer, Q tests every
survivor against the earlier ones (lower-triangular), S appends the
undominated ones by rank.  Each CTA reads its partition's branch on the
card; C then runs only where the count would pass ``wcap``.  What
bounds d is the footprint law (:func:`sweep_smem_bytes`):
:func:`check_args` refuses a (d, block) whose CTA would take more than
:data:`SMEM_LIMIT` bytes, and names the largest block that fits.
``sfs_sweep_cuda.launches`` counts entry calls, not grids, so a run can
show that its main path went through the kernel.
:func:`sweep_stages` runs the same grids with CUDA events between them,
for measurement only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["sfs_sweep_cuda", "sweep_stages", "check_args",
           "sweep_smem_bytes", "resident_rows", "filter_tile_rows",
           "largest_block", "prefix_rows", "entry_prefix", "NARROW_D",
           "MAX_BLOCK", "MAX_PARTS", "PREFIX_ROWS", "WIDE_PREFIX_ROWS",
           "WIDE_PREFIX_SHARE", "SMEM_LIMIT"]

NARROW_D = 12        # widest d with an instantiation of its own
MAX_BLOCK = 512      # one thread per candidate row of a block
MAX_PARTS = 2 ** 31 - 1  # A and C take the partitions on x; B on y, in
#                          slices of 65,535
PREFIX_ROWS = 4096   # rows stage A sweeps, rounded up to whole blocks
# past NARROW_D the entry sweeps npad / WIDE_PREFIX_SHARE rows in stage A,
# within WIDE_PREFIX_ROWS: A runs on one SM and Q spreads over the card,
# so a short prefix pays until the survivors grow large
WIDE_PREFIX_ROWS = (512, 4096)
WIDE_PREFIX_SHARE = 256
SMEM_LIMIT = 232_448  # shared memory one CTA may take on sm_90

# the constants of csrc/sfs_sweep.cu that its shared memory follows
_SEQ_THREADS = 512
_QUEUE_CAP = _SEQ_THREADS * 16 + _SEQ_THREADS   # kQueueCap
_RESIDENT_BYTES = 131_072                       # kResidentBytes
_FILTER_TILE_BYTES = 32_768                     # kFilterTileBytes
_LANE_ROWS = 32                                 # kLaneRows
_RANK_ROWS = 256 * 16                           # kRankRows, grids R and S
_PAIR_ROWS = 256 * 4                            # kPairRows: Q's tile
_PAIR_WAVES = 4                                 # kPairWaves
_PAIR_PARTS = 8                                 # kPairParts
_PAIR_MAX_SPLIT = 8                             # kPairMaxSplit
# A and C's bytes apart from the candidates and resident rows: the queue,
# the warp sums and the pending flags (kSeqFixedBytes)
_SEQ_FIXED = 4 * _QUEUE_CAP + 4 * 32 + 4 * _SEQ_THREADS


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
    lib.sfs_sweep_packed_launch.argtypes = (
        [i32, ptr, ptr, i64] + [ptr] * 8 + [i32] * 5 + [ptr])
    lib.sfs_sweep_packed_launch.restype = ctypes.c_int
    lib.sfs_sweep_smem_bytes.argtypes = [i32] * 5
    lib.sfs_sweep_smem_bytes.restype = i64
    lib.sfs_sweep_error_string.argtypes = [ctypes.c_int]
    lib.sfs_sweep_error_string.restype = ctypes.c_char_p
    return lib


def prefix_rows(npad: int, block: int, rows: int = PREFIX_ROWS) -> int:
    """The rows stage A sweeps: ``rows`` rounded up to whole blocks, at
    most ``npad``."""
    return min(npad, -(-rows // block) * block)


def entry_prefix(npad: int, d: int) -> int:
    """The prefix rows :func:`sfs_sweep_cuda` asks stage A for (before
    :func:`prefix_rows` rounds them): :data:`PREFIX_ROWS` up to
    :data:`NARROW_D`; past it ``npad / WIDE_PREFIX_SHARE`` within
    :data:`WIDE_PREFIX_ROWS`, chosen from stage times on the card
    (``PERF.md``).  Pure schedule: no prefix changes a bit."""
    if d <= NARROW_D:
        return PREFIX_ROWS
    lo, hi = WIDE_PREFIX_ROWS
    return min(hi, max(lo, npad // WIDE_PREFIX_SHARE))


def resident_rows(d: int, block: int) -> int:
    """Window rows stages A and C keep in shared memory at (d, block).

    Up to :data:`NARROW_D`, ``kResidentBytes`` of them.  Past it, what
    the candidate block leaves of :data:`SMEM_LIMIT`, at most
    ``kResidentBytes`` and at least ``kLaneRows`` rows (which may then
    not fit: the law exceeds the limit).  The source's
    ``resident_rows`` / ``resident_rows_wide``."""
    cap = _RESIDENT_BYTES // (4 * d)
    if d <= NARROW_D:
        return cap
    # a negative room is below kLaneRows however it is rounded
    room = (SMEM_LIMIT - _SEQ_FIXED - 4 * d * block) // (4 * d)
    return max(_LANE_ROWS, min(room, cap))


def filter_tile_rows(d: int) -> int:
    """Stage B's tile: ``kFilterTileBytes`` of coordinates, at least
    ``kLaneRows`` rows (the source's ``filter_tile_rows``)."""
    return max(_LANE_ROWS, _FILTER_TILE_BYTES // (4 * d))


def sweep_smem_bytes(d: int, block: int,
                     wcap: int = 2 ** 31 - 1) -> dict[str, int]:
    """The footprint law: the shared memory (all of it dynamic) that one
    CTA of each stage takes, by stage.

    Stages A and C (the sequential sweep): the candidate block, the row
    queue (a chunk of flags plus a partial block), the warp sums, one
    pending flag per thread and the :func:`resident_rows` window rows.
    Stage B: one tile of the prefix window, :func:`filter_tile_rows` and
    at most the prefix's ``min(prefix rows, wcap)`` rows.  Past
    :data:`NARROW_D` also the grids of the packed branch: ``rank`` (R
    and S: a tile's ranks and the warp sums) and ``pairs`` (Q: one tile
    of :func:`filter_tile_rows` survivors).  Counterpart of
    ``repro.kernels.sfs.kernel.sweep_vmem_bytes``; the kernel's
    ``sfs_sweep_smem_bytes`` computes the same numbers."""
    seq = 4 * d * block + _SEQ_FIXED + 4 * d * resident_rows(d, block)
    tile = min(filter_tile_rows(d), prefix_rows(2 ** 31 - 1, block), wcap)
    law = {"prefix": seq, "filter": 4 * d * tile, "survivors": seq}
    if d > NARROW_D:
        law.update(rank=4 * _RANK_ROWS + 4 * 32,
                   pairs=4 * d * filter_tile_rows(d))
    return law


def largest_block(d: int, wcap: int = 2 ** 31 - 1) -> int:
    """The largest block up to :data:`MAX_BLOCK` whose law fits
    :data:`SMEM_LIMIT` at ``d``; 0 when none does."""
    for block in range(MAX_BLOCK, 0, -1):
        if max(sweep_smem_bytes(d, block, wcap).values()) <= SMEM_LIMIT:
            return block
    return 0


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
    if d < 1:
        raise ValueError(f"sfs_sweep_cuda takes d >= 1, got {d}")
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
        most = largest_block(d, wcap)
        fits = (f"the largest block that fits at d={d} is {most}" if most
                else f"no block fits at d={d}")
        raise ValueError(f"sfs_sweep_cuda would take {over} bytes of shared "
                         f"memory per CTA at d={d}, block={block}, above "
                         f"{SMEM_LIMIT}; {fits}")


# the events sweep_stages records, in launch order; a grid's ms is the
# time from its event to the next
_MARKS = ("a", "b", "rank", "pairs", "append", "c", "end")


def _launch(pts_s, mask_s, block, wcap, sentinel, prefix, events=None):
    """Allocate the outputs and scratch and launch the grids on the
    current stream.  ``events``, when given, maps each name of
    :data:`_MARKS` to a CUDA event recorded before that grid (``end``
    after the last).  Returns ``(window, wmask, count, c_a,
    survivors)``; the last two are None when stage A covers the sweep."""
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
        if d > NARROW_D:
            # the packed branch's scratch: the survivors by coordinate,
            # their dominated bytes and one count per tile of R and S
            sv = torch.empty((p, d, stride), dtype=torch.float32, device=dev)
            dom = torch.empty((p, stride), dtype=torch.uint8, device=dev)
            tiles = torch.empty((p, -(-(npad - r0) // _RANK_ROWS)),
                                dtype=torch.int32, device=dev)
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

        def mark(name):
            if events is not None:
                events[name].record(stream)

        mark("a")
        check(lib.sfs_sweep_seq_launch(
            pts, mask, npad, 0, r0, win, wm, None, None,
            (count if c_a is None else c_a).data_ptr(), p, npad, d, block,
            wcap, s))
        if c_a is not None:
            mark("b")
            check(lib.sfs_sweep_filter_launch(
                pts, mask, win, c_a.data_ptr(), alive.data_ptr(), stride,
                surv.data_ptr(), p, npad, d, r0, wcap, s))
            if d > NARROW_D:
                for grid, name in enumerate(("rank", "pairs", "append")):
                    mark(name)
                    check(lib.sfs_sweep_packed_launch(
                        grid, pts, alive.data_ptr(), stride, sv.data_ptr(),
                        dom.data_ptr(), tiles.data_ptr(), c_a.data_ptr(),
                        surv.data_ptr(), win, wm, count.data_ptr(), p, npad,
                        d, r0, wcap, s))
            mark("c")
            check(lib.sfs_sweep_seq_launch(
                pts, alive.data_ptr(), stride, r0, npad, win, wm,
                c_a.data_ptr(), surv.data_ptr(), count.data_ptr(), p, npad,
                d, block, wcap, s))
        mark("end")
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
    _, npad, d = pts_s.shape
    window, wmask, count, _, _ = _launch(pts_s, mask_s, block, wcap,
                                         sentinel, entry_prefix(npad, d))
    sfs_sweep_cuda.launches += 1
    return window, wmask, count


sfs_sweep_cuda.launches = 0


def sweep_stages(pts_s: torch.Tensor, mask_s: torch.Tensor, *, block: int,
                 wcap: int, sentinel: float, prefix: int | None = None):
    """The sweep with CUDA events around its grids, for measurement: it
    synchronises, and its launches do not count on
    :func:`sfs_sweep_cuda`.  ``prefix`` sets stage A's rows (by default
    the entry's, :func:`entry_prefix`).

    Returns ``(outputs, info)``: the three outputs of the sweep, and per
    partition stage A's count ``c_a``, the rows B left alive
    ``survivors`` and whether the partition took the packed branch
    (``packed``; None where A covered the sweep), beside the ms of each
    grid (``a_ms``, ``b_ms``, ``c_ms`` and, past :data:`NARROW_D`, the
    packed branch's ``rank_ms``, ``pairs_ms`` and ``append_ms``; 0.0 for
    a grid that did not run) and ``prefix_rows``."""
    _check_device(pts_s, mask_s)
    check_args(pts_s, mask_s, block, wcap)
    if prefix is None:
        prefix = entry_prefix(pts_s.shape[1], pts_s.shape[2])
    events = {k: torch.cuda.Event(enable_timing=True) for k in _MARKS}
    window, wmask, count, c_a, surv = _launch(pts_s, mask_s, block, wcap,
                                              sentinel, prefix, events)
    events["end"].synchronize()
    p, npad, d = pts_s.shape
    info = {"prefix_rows": prefix_rows(npad, block, prefix),
            "a_ms": events["a"].elapsed_time(events["end"]), "b_ms": 0.0,
            "rank_ms": 0.0, "pairs_ms": 0.0, "append_ms": 0.0, "c_ms": 0.0,
            "c_a": count.tolist(), "survivors": [0] * p,
            "packed": [None] * p}
    if c_a is not None:
        ran = ("a", "b") + (("rank", "pairs", "append") if d > NARROW_D
                            else ()) + ("c", "end")
        info.update({f"{k}_ms": events[k].elapsed_time(events[e])
                     for k, e in zip(ran, ran[1:])})
        info.update(c_a=c_a.tolist(), survivors=surv.tolist(),
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
    built = {"prefix": seq,
             "filter": lib.sfs_sweep_smem_bytes(1, d, block, r0, wcap),
             "survivors": seq}
    if d > NARROW_D:
        built.update(rank=lib.sfs_sweep_smem_bytes(2, d, block, r0, wcap),
                     pairs=lib.sfs_sweep_smem_bytes(3, d, block, r0, wcap))
    return built
