"""Filtering layers: Grid Filtering (paper §3.2) and Representative
Filtering (§4.1).

Counterpart of ``repro.core.filtering``.  ``grid_filter`` drops every
tuple whose grid cell is strictly grid-dominated by an occupied cell; it
is integer work on the cell coordinates (no kernel).  The
representative functions take an optional leading batch axis, as the
reference's ``vmap`` over partitions gives them: points (P, n, d), mask
(P, n).  The dominance tests inside are one launch each, whatever P.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.dominance import (apply_sentinel, dominated_mask,
                                        monotone_score, region_volume,
                                        topk_order)
from repro_torch.core.partition import grid_cell_coords

__all__ = ["grid_filter", "select_representatives",
           "filter_by_representatives", "GridFilterResult"]


class GridFilterResult(NamedTuple):
    mask: torch.Tensor          # updated tuple validity
    pruned_cells: torch.Tensor  # (m,)*d bool, cells disregarded entirely
    dropped: torch.Tensor       # () int32 tuples dropped


def _exclusive_cumor(x: torch.Tensor, axis: int) -> torch.Tensor:
    """OR of strictly earlier entries along ``axis`` (x in {0, 1})."""
    xi = x.to(torch.int32)
    return (torch.cumsum(xi, dim=axis, dtype=torch.int32) - xi) > 0


def grid_filter(pts: torch.Tensor, mask: torch.Tensor,
                m: int) -> GridFilterResult:
    """Grid Filtering (paper §3.2): a cell strictly grid-dominated by an
    occupied cell is disregarded entirely.  Exclusive cumulative ORs
    along every axis give exactly "some occupied cell has every
    coordinate strictly smaller"; the cumulative sums are integer and
    exact.

    The reference counts the valid rows of each cell and tests the count
    for > 0.  Here each valid row marks its cell in a flag vector with a
    plain scatter (invalid rows mark a spare slot), which gives the same
    occupancy: an accumulating ``index_put_`` sorts its indices and adds
    the rows of a cell one after another on the card, which took 93-427
    ms at N = 10^7 on skewed cells on an H100 (``PERF.md``).

    (Q, N, d) points filter Q queries at once: query q's flags start at
    q * (m^d + 1), and every field gains the Q axis."""
    if pts.ndim == 2:
        out = grid_filter(pts[None], mask[None], m)
        return GridFilterResult(*(x[0] for x in out))
    q, _, d = pts.shape
    dev = pts.device
    coords = grid_cell_coords(pts, m)
    cells = m ** d
    radix = m ** torch.arange(d - 1, -1, -1, device=dev)
    flat = (coords.long() * radix).sum(dim=-1)      # row-major cell index
    base = torch.arange(q, device=dev)[:, None] * (cells + 1)
    occ = torch.zeros((q * (cells + 1),), dtype=torch.bool, device=dev)
    # index_fill_ takes the value as a scalar argument; occ[idx] = True
    # would first copy it to the card from pageable memory (a host sync)
    occ.index_fill_(0, (torch.where(mask, flat, cells) + base).reshape(-1),
                    True)
    strict = occ.reshape(q, cells + 1)[:, :cells].reshape((q,) + (m,) * d)
    for axis in range(1, d + 1):
        strict = _exclusive_cumor(strict, axis)
    keep = mask & ~torch.gather(strict.reshape(q, cells), 1, flat)
    dropped = (mask.sum(dim=-1) - keep.sum(dim=-1)).to(torch.int32)
    return GridFilterResult(keep, strict, dropped)


def uniform_draws(shape, generator) -> torch.Tensor:
    """Uniform draws of ``shape``: from one generator, or, given a
    sequence of Q generators, the leading axis cut into Q equal runs,
    each drawn from its own."""
    if not isinstance(generator, (list, tuple)):
        return torch.rand(shape, generator=generator,
                          device=generator.device)
    run = (shape[0] // len(generator),) + tuple(shape[1:])
    return torch.cat([torch.rand(run, generator=g, device=g.device)
                      for g in generator])


def select_representatives(pts: torch.Tensor, mask: torch.Tensor, k: int, *,
                           strategy: str = "sorted",
                           generator: torch.Generator | None = None,
                           draws: torch.Tensor | None = None,
                           impl: str = "auto"):
    """Pick k representative tuples (paper §4.1) and drop the dominated
    ones among them before they are shared.

    Strategies: 'sorted' (first k in monotone-score order), 'region'
    (largest dominance-region volume prod(1 - t[i]); [0,1] data), 'random'
    (a baseline; draws from ``generator``, which it needs: one
    ``torch.Generator``, or one per equal run of the leading axis; or
    takes ``draws``, uniforms of ``mask``'s shape drawn by the caller, as
    a mesh rank's share of the whole batch's draws).  The
    pick is ``jax.lax.top_k``'s: descending merit, ``+0.0`` above
    ``-0.0``, the lower index first among equal merits
    (``topk_order``)."""
    if strategy == "sorted":
        merit = -monotone_score(pts, mask)          # larger = better
    elif strategy == "region":
        merit = region_volume(pts)
    elif strategy == "random":
        if draws is None:
            if generator is None:
                raise ValueError("the random strategy needs a "
                                 "torch.Generator")
            draws = uniform_draws(mask.shape, generator)
        merit = draws.to(pts.device)
    else:
        raise ValueError(f"unknown representative strategy {strategy!r}")
    merit = torch.where(mask, merit, torch.full_like(merit, -float("inf")))
    # tiny partitions (streaming chunks smaller than k) cannot yield more
    # representatives than they hold rows
    idx = topk_order(merit)[..., :min(k, pts.shape[-2])]
    repmask = torch.gather(mask, -1, idx)
    # filler rows of a partition with fewer than k valid rows are
    # sentinel-filled, so no point data leaks into the shared pool
    reps = apply_sentinel(torch.gather(
        pts, -2, idx[..., None].expand(idx.shape + pts.shape[-1:])), repmask)
    repmask = repmask & ~dominated_mask(reps, reps, repmask, impl=impl)
    return reps, repmask


def filter_by_representatives(pts: torch.Tensor, mask: torch.Tensor,
                              reps: torch.Tensor, repmask: torch.Tensor, *,
                              impl: str = "auto") -> torch.Tensor:
    """Delete any tuple dominated by a representative (paper §4.1)."""
    return mask & ~dominated_mask(pts, reps, repmask, impl=impl)
