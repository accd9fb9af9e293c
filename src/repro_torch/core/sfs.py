"""Skyline algorithms: the O(N^2) oracle and block-SFS.

Counterpart of ``repro.core.sfs``.  The local phase is ONE call:
:func:`local_skyline_batch` sorts a batch of partitions by the strictly
monotone score (a topological order of dominance), sentinel-fills and
block-pads them, and hands the whole batch to the fused SFS sweep
(``repro_torch.kernels.sfs.sfs_sweep``): one kernel launch on the
card.

Blocked SFS is exact by transitivity: if the only in-block dominator of
t is itself dominated by a window member w, then w dominates t too, so t
still falls to the window test.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.dominance import (SENTINEL, apply_sentinel,
                                        dominated_mask, monotone_score,
                                        stable_argsort)
from repro_torch.kernels.backend import resolve_device, resolve_spec
from repro_torch.kernels.dominance import dominated_mask_ref
from repro_torch.kernels.sfs import sfs_sweep

__all__ = ["SkyBuffer", "naive_skyline_mask", "skyline_mask", "sweep_inputs",
           "block_sfs", "local_skyline_batch", "compact", "compact_order",
           "as_inputs"]

# candidates per step of the O(N^2) oracle; bounds its (N, chunk)
# temporaries
_ORACLE_CHUNK = 1024


class SkyBuffer(NamedTuple):
    """Fixed-capacity masked skyline buffer."""
    points: torch.Tensor    # (C, d) packed members (leading axes allowed)
    mask: torch.Tensor      # (C,) bool
    count: torch.Tensor     # () int32, the true skyline size (may exceed C)
    overflow: torch.Tensor  # () bool, True iff count > C


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def naive_skyline_mask(pts: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """O(N^2) oracle; membership mask in input order."""
    n = pts.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=pts.device)
    dom = torch.zeros_like(mask)
    for i in range(0, n, _ORACLE_CHUNK):
        dom[i:i + _ORACLE_CHUNK] = dominated_mask_ref(
            pts[i:i + _ORACLE_CHUNK], pts, mask)
    return mask & ~dom


def as_inputs(pts, mask, device):
    """``(pts, mask)`` as float32 and bool tensors on the entry points'
    device (:func:`repro_torch.kernels.backend.resolve_device`)."""
    device = resolve_device(device)
    pts = torch.as_tensor(pts, device=device).to(torch.float32)
    if mask is not None:
        mask = torch.as_tensor(mask, device=device).bool()
    return pts, mask


def skyline_mask(pts, mask=None, *, impl: str = "auto",
                 device=None) -> torch.Tensor:
    """Blocked O(N^2) skyline membership mask, in input order: one
    dominance launch of the point set against itself.  Runs on the card
    unless ``device="cpu"``."""
    pts, mask = as_inputs(pts, mask, device)
    if mask is None:
        mask = torch.ones(pts.shape[:1], dtype=torch.bool, device=pts.device)
    dom = dominated_mask(pts, pts, mask,
                         impl=resolve_spec(impl, pts.device).dominance)
    return mask & ~dom


def sweep_inputs(pts: torch.Tensor, mask: torch.Tensor, *, capacity: int,
                 block: int):
    """The sweep call that :func:`local_skyline_batch` makes for a
    (P, n, d) batch: every partition sorted by the monotone score
    (stable, invalid rows last), invalid rows sentinel-filled, rows
    padded to a multiple of the block, which is clipped to n.

    Returns ``(pts (P, npad, d), mask (P, npad), block, wcap)``."""
    p, n, d = pts.shape
    block = min(block, max(n, 1))
    order = stable_argsort(monotone_score(pts, mask), dim=-1)
    mask_s = torch.gather(mask, 1, order)
    pts_s = apply_sentinel(
        torch.gather(pts, 1, order[..., None].expand(p, n, d)), mask_s)
    npad = _ceil_to(max(n, 1), block)
    pts_p = torch.full((p, npad, d), SENTINEL, dtype=pts.dtype,
                       device=pts.device)
    pts_p[:, :n] = pts_s
    mask_p = torch.zeros((p, npad), dtype=torch.bool, device=pts.device)
    mask_p[:, :n] = mask_s
    return pts_p, mask_p, block, _ceil_to(capacity, block)


def local_skyline_batch(pts: torch.Tensor, mask: torch.Tensor | None = None,
                        *, capacity: int, block: int = 256,
                        impl: str = "auto", wtile: int = 0) -> SkyBuffer:
    """Blocked Sort-Filter-Skyline of a (P, N, d) partition batch in one
    sweep call.

    Every leaf of the returned :class:`SkyBuffer` carries a leading P
    axis.  Exact per partition whenever |SKY| <= capacity; otherwise the
    overflow flag is set and the buffer is a subset of the skyline.

    Precondition: valid coordinates stay below ``SENTINEL``; the sweeps
    rely on sentinel-filled rows being inert in dominance tests."""
    if pts.ndim != 3:
        raise ValueError(f"expected a (P, N, d) batch, got "
                         f"{tuple(pts.shape)}")
    if mask is None:
        mask = torch.ones(pts.shape[:2], dtype=torch.bool, device=pts.device)
    pts_p, mask_p, block, wcap = sweep_inputs(pts, mask, capacity=capacity,
                                              block=block)
    window, wmask, count = sfs_sweep(pts_p, mask_p, block=block, wcap=wcap,
                                     sentinel=SENTINEL, wtile=wtile,
                                     spec=impl)
    return SkyBuffer(window, wmask, count, count > capacity)


def block_sfs(pts: torch.Tensor, mask: torch.Tensor | None = None, *,
              capacity: int, block: int = 256, impl: str = "auto",
              wtile: int = 0) -> SkyBuffer:
    """Blocked Sort-Filter-Skyline of ONE point set: the batched entry
    with a single partition."""
    buf = local_skyline_batch(
        pts[None], None if mask is None else mask[None],
        capacity=capacity, block=block, impl=impl, wtile=wtile)
    return SkyBuffer(buf.points[0], buf.mask[0], buf.count[0],
                     buf.overflow[0])


def compact_order(mask: torch.Tensor, capacity: int) -> torch.Tensor:
    """The row order `compact` gathers by: valid rows first, stable,
    truncated to ``capacity`` (along the last axis)."""
    return stable_argsort((~mask).to(torch.uint8))[..., :capacity]


def gather_rows(pts: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``pts[..., order, :]`` with one row order per leading index."""
    return torch.gather(pts, -2, order[..., None].expand(
        order.shape + pts.shape[-1:]))


def compact(pts: torch.Tensor, mask: torch.Tensor, capacity: int,
            out: tuple[torch.Tensor, torch.Tensor] | None = None) -> SkyBuffer:
    """Stable-move valid rows to the front; truncate to capacity.
    Leading axes are batch axes, compacted each on its own.  ``out``
    (points, mask), shaped like the result and sharing no memory with
    the inputs, receives it in place."""
    order = compact_order(mask, capacity)
    if out is None:
        mask_c = torch.gather(mask, -1, order)
        pts_c = apply_sentinel(gather_rows(pts, order), mask_c)
    else:
        mask_c = torch.gather(mask, -1, order, out=out[1])
        pts_c = torch.gather(pts, -2, order[..., None].expand(
            order.shape + pts.shape[-1:]), out=out[0])
        pts_c.masked_fill_(~mask_c[..., None], SENTINEL)
    count = mask.sum(dim=-1).to(torch.int32)
    return SkyBuffer(pts_c, mask_c, count, count > capacity)
