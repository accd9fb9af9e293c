"""Partitioning: the SLICED strategy and the routing into buckets.

Counterpart of ``repro.core.partition``.  A strategy maps every tuple to
a partition id in [0, p); `bucketize` routes tuples into fixed-capacity
per-partition buckets, the static-shape analogue of Spark's shuffle.
The random, grid and angular id maps are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.dominance import SENTINEL, stable_argsort

__all__ = ["Buckets", "sliced_part_ids", "bucketize", "grid_num_parts",
           "angular_num_parts", "slices_for_target_parts"]


class Buckets(NamedTuple):
    points: torch.Tensor    # (p, C, d)
    mask: torch.Tensor      # (p, C) bool
    counts: torch.Tensor    # (p,) int32 true per-partition populations
    overflow: torch.Tensor  # () bool, some partition exceeded capacity


def sliced_part_ids(pts: torch.Tensor, mask: torch.Tensor, p: int,
                    dim: int = 0) -> torch.Tensor:
    """SLICED (paper §3.4): sort on one dimension (index tie-break, so a
    total order), cut into p equal runs: p(t) = floor(rank * p / N_valid)."""
    n = pts.shape[0]
    v = torch.where(mask, pts[:, dim], torch.full_like(pts[:, dim],
                                                       float("inf")))
    order = stable_argsort(v)
    ranks = torch.empty((n,), dtype=torch.int64, device=pts.device)
    ranks[order] = torch.arange(n, device=pts.device)
    nvalid = mask.sum().clamp(min=1)
    return torch.clamp(ranks * p // nvalid, 0, p - 1).to(torch.int32)


# partition-count helpers (paper §5.2: p is m^d for GRID, m^(d-1) for
# ANGULAR; m is chosen to get closest to the target p)

def grid_num_parts(m: int, d: int) -> int:
    return m ** d


def angular_num_parts(m: int, d: int) -> int:
    return m ** (d - 1)


def slices_for_target_parts(target_p: int, dims: int) -> int:
    """Closest m >= 1 such that m^dims ~ target_p."""
    m = max(1, round(target_p ** (1.0 / dims)))
    best, best_gap = m, abs(m ** dims - target_p)
    for cand in (m - 1, m + 1, m + 2):
        if cand >= 1 and abs(cand ** dims - target_p) < best_gap:
            best, best_gap = cand, abs(cand ** dims - target_p)
    return best


def bucketize(pts: torch.Tensor, mask: torch.Tensor, ids: torch.Tensor,
              p: int, capacity: int) -> Buckets:
    """Route tuples to (p, capacity) buckets with validity masks.

    Stable sort by partition id (invalid rows sort to a virtual partition
    p), positions within a partition by searchsorted on the sorted ids;
    rows beyond capacity are dropped and flagged as overflow."""
    n, d = pts.shape
    dev = pts.device
    ids_eff = torch.where(mask, ids.to(torch.int64), p)
    order = stable_argsort(ids_eff)
    ids_s = ids_eff[order]
    pts_s = pts[order]
    mask_s = mask[order]
    pos = torch.arange(n, device=dev) - torch.searchsorted(ids_s, ids_s)
    ok = mask_s & (ids_s < p) & (pos < capacity)
    # row p * capacity is a dump slot for the dropped rows
    dest = torch.where(ok, ids_s * capacity + pos, p * capacity)
    flat = torch.full((p * capacity + 1, d), SENTINEL, dtype=pts.dtype,
                      device=dev)
    flat[dest] = pts_s
    fmask = torch.zeros((p * capacity + 1,), dtype=torch.bool, device=dev)
    fmask[dest] = ok
    counts = torch.zeros((p + 1,), dtype=torch.int64, device=dev)
    counts.index_add_(0, ids_eff, torch.ones_like(ids_eff))
    counts = counts[:p].to(torch.int32)
    return Buckets(flat[:-1].reshape(p, capacity, d),
                   fmask[:-1].reshape(p, capacity), counts,
                   (counts > capacity).any())
