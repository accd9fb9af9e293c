"""Skyline state and the fresh-state insert behind the one-shot pipeline.

Counterpart of the fresh-state path of ``repro.core.incremental``.  In
the reference, one-shot ``parallel_skyline`` is "insert everything into
an empty state": the fresh insert skips the pre-filter and eviction
passes, so its body is exactly partition -> local -> merge, and the
state's buffer is the answer.  This module ports that path.  Inserting
into a live state (pre-filter, evict, merge) raises
``NotImplementedError`` until the streaming slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import parallel as par
from repro_torch.core.dominance import SENTINEL
from repro_torch.core.parallel import SkyConfig
from repro_torch.core.sfs import SkyBuffer

__all__ = ["SkylineState", "state_capacity"]


class SkylineState(NamedTuple):
    """Fixed-capacity running skyline.  The buffer is an antichain
    holding the skyline of every valid tuple fed so far (unless
    ``overflow`` reports that capacity was exceeded)."""
    points: torch.Tensor    # (C, d) packed members
    mask: torch.Tensor      # (C,) bool validity
    count: torch.Tensor     # () int32, live skyline size
    overflow: torch.Tensor  # () bool, capacity ever exceeded
    seen: torch.Tensor      # () int32, valid tuples fed so far
    chunks: torch.Tensor    # () int32, inserts absorbed


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def state_capacity(cfg: SkyConfig) -> int:
    """Row count of the state buffer: the final-merge window size
    (capacity rounded up to the block), so the one-shot answer drops
    into a state with no reshaping."""
    return _ceil_to(max(cfg.capacity, 1), cfg.block)


def _fit_rows(points: torch.Tensor, mask: torch.Tensor, rows: int):
    """Pad (sentinel/False) or truncate the row axis to ``rows``.

    The merge window is capacity rounded to the *effective* block (the
    block is clipped to the union size for tiny unions), so its row
    count can differ from ``state_capacity``; truncation is safe because
    members never exceed the compacted union, which is below the state
    capacity whenever the shapes differ."""
    c = points.shape[-2]
    if c >= rows:
        return points[..., :rows, :], mask[..., :rows]
    pad_p = torch.full(points.shape[:-2] + (rows - c, points.shape[-1]),
                       SENTINEL, dtype=points.dtype, device=points.device)
    pad_m = torch.zeros(mask.shape[:-1] + (rows - c,), dtype=torch.bool,
                        device=mask.device)
    return torch.cat([points, pad_p], -2), torch.cat([mask, pad_m], -1)


def _chunk_skyline(pts, mask, *, cfg: SkyConfig):
    """SKY(chunk) via partition -> local -> merge."""
    buckets, stats = par.partition_stage(pts, mask, cfg)
    final, s2 = par._local_merge(buckets.points, buckets.mask, cfg=cfg)
    stats.update(s2)
    overflow = buckets.overflow | stats["local_overflow"] | final.overflow
    return SkyBuffer(final.points, final.mask, final.count, overflow), stats


def _insert(state: SkylineState | None, pts, mask, *, cfg: SkyConfig):
    """One query's insert step; ``state=None`` is the fresh-state path,
    exactly the one-shot pipeline."""
    if state is not None:
        raise NotImplementedError(
            "inserting into a live SkylineState is not ported yet; see "
            "ROADMAP.md, 'Modules still to port', item 5")
    sky, stats = _chunk_skyline(pts, mask, cfg=cfg)
    new_pts, new_mask = _fit_rows(sky.points, sky.mask, state_capacity(cfg))
    nst = SkylineState(new_pts, new_mask, sky.count, sky.overflow,
                       seen=stats["n_valid"],
                       chunks=torch.ones((), dtype=torch.int32,
                                         device=pts.device))
    return nst, stats
