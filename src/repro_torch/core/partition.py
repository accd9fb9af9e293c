"""Partitioning strategies (paper §3): RANDOM, GRID, ANGULAR, SLICED.

Counterpart of ``repro.core.partition``.  A strategy maps every tuple to
a partition id in [0, p); `bucketize` routes tuples into fixed-capacity
per-partition buckets, the static-shape analogue of Spark's shuffle.

The grid and angular maps are bit for bit the reference's ids: their
arithmetic flushes subnormals (``core.dominance.flush_subnormal``), and
the angular tail sums are accumulated from the last attribute, as the
reference's reversed cumulative sum adds.  ``atan2`` is the device's
own, so angles may differ in the last bit; the ids are what is held
against the reference.  RANDOM draws from a ``torch.Generator``, which
cannot reproduce ``jax.random``'s bits: the ids are balanced the same
way, not equal.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.dominance import (SENTINEL, flush_subnormal,
                                        stable_argsort_rows)

__all__ = ["Buckets", "random_part_ids", "grid_cell_coords", "grid_part_ids",
           "angular_part_ids", "sliced_part_ids", "bucketize",
           "grid_num_parts", "angular_num_parts", "slices_for_target_parts"]


class Buckets(NamedTuple):
    """Routed buckets; a batch of Q queries adds a leading Q axis to
    every leaf."""
    points: torch.Tensor    # (p, C, d)
    mask: torch.Tensor      # (p, C) bool
    counts: torch.Tensor    # (p,) int32 true per-partition populations
    overflow: torch.Tensor  # () bool, some partition exceeded capacity


def random_part_ids(generator: torch.Generator, n: int, p: int, *,
                    device=None) -> torch.Tensor:
    """Balanced random assignment (paper §3.1): a random permutation of
    ``arange(n) % p``, exactly equi-numerous when p divides n, drawn from
    ``generator`` on its device and moved to ``device`` (the generator's
    when None)."""
    gdev = generator.device
    perm = torch.randperm(n, generator=generator, device=gdev)
    ids = (torch.arange(n, dtype=torch.int32, device=gdev) % p)[perm]
    return ids.to(device or gdev)


def grid_cell_coords(pts: torch.Tensor, m: int) -> torch.Tensor:
    """(..., N, d) int32 grid coordinates on [0,1]^d with m slices per dim.
    The product of a flushed coordinate and m >= 1 is zero, normal or
    infinite, so it needs no flush of its own."""
    cell = torch.floor(flush_subnormal(pts) * m)
    return torch.clamp(cell, 0, m - 1).to(torch.int32)


def _radix_sum(coords: torch.Tensor, m: int) -> torch.Tensor:
    """sum_i coords[..., i] * m^i in int32."""
    radix = m ** torch.arange(coords.shape[-1], dtype=torch.int32,
                              device=coords.device)
    return (coords * radix).sum(dim=-1, dtype=torch.int32)


def grid_part_ids(pts: torch.Tensor, m: int) -> torch.Tensor:
    """p(t) = sum_i floor(t[A_i] * m) * m^(i-1) (paper §3.2)."""
    return _radix_sum(grid_cell_coords(pts, m), m)


def angular_part_ids(pts: torch.Tensor, m: int) -> torch.Tensor:
    """Hyperspherical partitioning (paper §3.3, Eq. 1): a grid on the
    d - 1 angular coordinates, phi_i = atan(sqrt(sum_{j>i} x_j^2) / x_i).

    The tail sums are accumulated one attribute at a time from the last,
    as the reference's reversed ``cumsum`` adds (``torch.cumsum`` on the
    flipped array uses another order and other bits).  Squares, angles
    and scaled angles are flushed; sums of flushed squares and their
    square roots cannot be subnormal.  The ids are those of the
    reference under ``jit``, as its pipeline runs them."""
    lead, d = pts.shape[:-1], pts.shape[-1]
    if d < 2:
        return torch.zeros(lead, dtype=torch.int32, device=pts.device)
    x = flush_subnormal(pts.to(torch.float32))
    x2 = flush_subnormal(x * x)
    tails = [torch.zeros(lead, dtype=torch.float32, device=pts.device)]
    acc = x2[..., d - 1]
    for i in range(d - 2, -1, -1):
        tails.append(acc)              # tail[i] = sum_{j > i} x_j^2
        acc = acc + x2[..., i]
    tail = torch.stack(tails[::-1][:d - 1], dim=-1)
    phi = flush_subnormal(torch.atan2(torch.sqrt(tail),
                                      x[..., :d - 1]))  # [0, pi/2]
    # the reference's 2.0 * phi / pi * m runs under jit, where XLA folds
    # the constants into one product with f32((2 / pi) * m)
    scale = float(np.float32(np.float32(2.0) / np.float32(np.pi))
                  * np.float32(m))
    scaled = flush_subnormal(phi * scale)
    slot = torch.clamp(torch.floor(scaled), 0, m - 1).to(torch.int32)
    return _radix_sum(slot, m)


def sliced_part_ids(pts: torch.Tensor, mask: torch.Tensor, p: int,
                    dim: int = 0) -> torch.Tensor:
    """SLICED (paper §3.4): sort on one dimension (index tie-break, so a
    total order), cut into p equal runs: p(t) = floor(rank * p / N_valid).

    (Q, N, d) points take one stable sort of all Q x N keys
    (`stable_argsort_rows`), each query cut by its own valid count."""
    n = pts.shape[-2]
    v = pts[..., dim]
    v = torch.where(mask, v, torch.full_like(v, float("inf")))
    order = stable_argsort_rows(v if v.ndim == 2 else v[None]).reshape(
        v.shape)
    ranks = torch.empty(order.shape, dtype=torch.int64, device=pts.device)
    ranks.scatter_(-1, order, torch.arange(n, device=pts.device).expand(
        order.shape))
    nvalid = mask.sum(dim=-1, keepdim=True).clamp(min=1)
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
    rows beyond capacity are dropped and flagged as overflow.

    (Q, N, d) points route Q queries at once: one stable sort of all
    Q x N ids (`stable_argsort_rows`), one batched searchsorted, and one scatter whose destinations query q
    offsets by q * (p * capacity + 1); every leaf gains the Q axis."""
    if pts.ndim == 2:
        out = bucketize(pts[None], mask[None], ids[None], p, capacity)
        return Buckets(*(x[0] for x in out))
    q, n, d = pts.shape
    dev = pts.device
    ids_eff = torch.where(mask, ids.to(torch.int64), p)
    order = stable_argsort_rows(ids_eff)
    ids_s = torch.gather(ids_eff, -1, order)
    pts_s = torch.gather(pts, 1, order[..., None].expand(q, n, d))
    mask_s = torch.gather(mask, -1, order)
    pos = torch.arange(n, device=dev) - torch.searchsorted(ids_s, ids_s)
    ok = mask_s & (ids_s < p) & (pos < capacity)
    # row p * capacity of each query is a dump slot for its dropped rows
    span = p * capacity + 1
    base = torch.arange(q, device=dev)[:, None] * span
    dest = torch.where(ok, ids_s * capacity + pos, p * capacity) + base
    flat = torch.full((q * span, d), SENTINEL, dtype=pts.dtype, device=dev)
    flat[dest.reshape(-1)] = pts_s.reshape(-1, d)
    fmask = torch.zeros((q * span,), dtype=torch.bool, device=dev)
    fmask[dest.reshape(-1)] = ok.reshape(-1)
    counts = torch.zeros((q * (p + 1),), dtype=torch.int64, device=dev)
    cidx = ids_eff + torch.arange(q, device=dev)[:, None] * (p + 1)
    counts.index_add_(0, cidx.reshape(-1), torch.ones_like(cidx).reshape(-1))
    counts = counts.reshape(q, p + 1)[:, :p].to(torch.int32)
    flat = flat.reshape(q, span, d)[:, :-1]
    fmask = fmask.reshape(q, span)[:, :-1]
    return Buckets(flat.reshape(q, p, capacity, d),
                   fmask.reshape(q, p, capacity), counts,
                   (counts > capacity).any(dim=-1))
