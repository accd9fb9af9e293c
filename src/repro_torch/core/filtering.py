"""Representative Filtering (paper §4.1).

Counterpart of the representative half of ``repro.core.filtering``:
``select_representatives`` and ``filter_by_representatives``.  Grid
Filtering (§3.2) comes with the grid strategy (ROADMAP.md item 4a).

Both functions take an optional leading batch axis, as the reference's
``vmap`` over partitions gives them: points (P, n, d), mask (P, n).  The
dominance tests inside are one launch each, whatever P.
"""

from __future__ import annotations

import torch

from repro_torch.core.dominance import (apply_sentinel, dominated_mask,
                                        monotone_score, region_volume,
                                        topk_order)

__all__ = ["select_representatives", "filter_by_representatives"]


def select_representatives(pts: torch.Tensor, mask: torch.Tensor, k: int, *,
                           strategy: str = "sorted",
                           generator: torch.Generator | None = None,
                           impl: str = "auto"):
    """Pick k representative tuples (paper §4.1) and drop the dominated
    ones among them before they are shared.

    Strategies: 'sorted' (first k in monotone-score order), 'region'
    (largest dominance-region volume prod(1 - t[i]); [0,1] data), 'random'
    (a baseline; draws from ``generator``, which it needs).  The pick is
    ``jax.lax.top_k``'s: descending merit, ``+0.0`` above ``-0.0``, the
    lower index first among equal merits (``topk_order``)."""
    if strategy == "sorted":
        merit = -monotone_score(pts, mask)          # larger = better
    elif strategy == "region":
        merit = region_volume(pts)
    elif strategy == "random":
        if generator is None:
            raise ValueError("the random strategy needs a torch.Generator")
        merit = torch.rand(mask.shape, generator=generator,
                           device=generator.device).to(pts.device)
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
