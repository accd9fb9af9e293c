"""Dominance primitives and the orders built on them.

Counterpart of ``repro.core.dominance``.  Point sets are masked:
``(pts: (N, d) f32, mask: (N,) bool)``.  Invalid rows also carry the
``SENTINEL`` coordinate, so a sentinel row can never dominate a real
point even where a mask is dropped.

The orders are bit-for-bit those of the reference:

* ``monotone_score`` adds the attributes left to right in f32, from a
  +0.0 accumulator, as XLA:CPU's reduce does.  ``torch.sum`` uses another
  order and gives other bits on a third or more of the rows for several d.
* every sort is stable and compares ``-0.0`` equal to ``+0.0`` (the
  reference's sorts canonicalise signed zeros); :func:`sort_key` makes
  that hold on every device, whatever its sort does with the sign bit.

Subnormal numbers are flushed as XLA flushes them on the CPU (and as a
TPU does): a comparison sees a subnormal operand as a zero of the same
sign, an arithmetic result that is subnormal becomes a zero of the same
sign, and sorts rank subnormals equal to both zeros.  Data movement
(gathers, ``where``, compaction) keeps the stored bits.  Every
comparison and sum here goes through :func:`flush_subnormal`.
"""

from __future__ import annotations

import torch

# the dominance entry the core modules call, and the flush, which lives
# beside the dominance oracle (the lowest layer that compares
# coordinates) so that the kernels' plain versions share it
from repro_torch.kernels.dominance import dominated_mask, flush_subnormal

__all__ = [
    "SENTINEL", "flush_subnormal", "dominates", "dominated_mask",
    "region_volume",
    "monotone_score", "canonical_order", "apply_sentinel", "sort_key",
    "stable_argsort", "stable_argsort_rows", "topk_order",
]

# Large but finite.  Sums of sentinels overflow to inf once d >= 3; an
# overflowed sentinel score still sorts last, which is all that is needed.
SENTINEL = 1.7e38


def dominates(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Scalar predicate: does point t dominate point s?"""
    t, s = flush_subnormal(t), flush_subnormal(s)
    return torch.all(t <= s) & torch.any(t < s)


def region_volume(pts: torch.Tensor) -> torch.Tensor:
    """Volume of the dominance region on [0,1]^d (paper §4.1):
    prod_k clip(1 - t[k], 0, 1), multiplied left to right as XLA's
    reduce does (a one-attribute product is the factor itself), each
    partial product flushed."""
    f = torch.clamp(1.0 - flush_subnormal(pts), 0.0, 1.0)
    v = f[..., 0].clone()
    for k in range(1, pts.shape[-1]):
        v = flush_subnormal(v * f[..., k])
    return v


def monotone_score(pts: torch.Tensor,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """The strictly monotone SFS presort score (sum of the attributes).

    Invalid rows score +inf so they sort last.  A one-attribute sum is
    the attribute itself (XLA folds that reduce to a copy, keeping -0.0
    and a subnormal's bits); wider sums start from +0.0 and flush each
    operand and each partial sum."""
    d = pts.shape[-1]
    if d == 1:
        s = pts[..., 0].clone()
    else:
        x = flush_subnormal(pts)
        s = torch.zeros(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
        for k in range(d):
            s = flush_subnormal(s + x[..., k])
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, float("inf")))
    return s


def sort_key(v: torch.Tensor) -> torch.Tensor:
    """``v`` with -0.0 and the subnormals replaced by +0.0, so that any
    sort ranks them all as equal and a stable sort keeps them in input
    order."""
    return torch.where(v.abs() < torch.finfo(v.dtype).tiny,
                       torch.zeros_like(v), v)


def stable_argsort(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Stable ascending argsort with signed zeros and subnormals compared
    equal."""
    if v.is_floating_point():
        v = sort_key(v)
    return torch.sort(v, dim=dim, stable=True).indices


def stable_argsort_rows(v: torch.Tensor) -> torch.Tensor:
    """`stable_argsort` of each row of a (Q, N) batch, in ONE sort of the
    Q x N keys whatever Q and N.

    A batched ``torch.sort`` on the card sorts rows of 10^6 keys or more
    one row at a time (PyTorch's schedule), so its launches would grow
    with Q.  Here each key becomes 32 bits in the same order (f32: the
    bits of `sort_key` mapped to integers in the floats' order, NaN last;
    integers must fit in int32), the row index goes above them in an
    int64, and one stable sort of the flat keys orders every row.  Other
    dtypes, and a single row, take `stable_argsort`."""
    q, n = v.shape
    if q == 1 or not (v.dtype == torch.float32 or not v.is_floating_point()):
        return stable_argsort(v)
    if v.is_floating_point():
        v = sort_key(v)
        bits = torch.where(torch.isnan(v), float("nan"), v).view(torch.int32)
        v = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    rows = torch.arange(q, dtype=torch.int64, device=v.device)[:, None]
    key = (rows << 32) + (v.to(torch.int32).to(torch.int64) + 2 ** 31)
    flat = torch.sort(key.reshape(-1), stable=True).indices
    return flat.reshape(q, n) - rows * n


def topk_order(merit: torch.Tensor) -> torch.Tensor:
    """Argsort of the last axis in ``jax.lax.top_k``'s order: descending,
    ``+0.0`` above ``-0.0``, and the lower index first among equal
    values.  The f32 bits are mapped to integers in the floats' total
    order and sorted stably, so no device's float sort can differ."""
    bits = merit.to(torch.float32).view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.sort(key, dim=-1, descending=True, stable=True).indices


def canonical_order(pts: torch.Tensor,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Permutation sorting by monotone score, then the coordinates
    lexicographically: a total order on point values, so the result does
    not depend on the input permutation.  Invalid rows sort last.
    Leading axes are batch axes: each row set is ordered on its own.

    ``jnp.lexsort`` becomes a chain of stable sorts from the least
    significant key (the last coordinate) to the most (the score)."""
    score = monotone_score(pts, mask)
    keys = [pts[..., k] for k in reversed(range(pts.shape[-1]))] + [score]
    perm = torch.arange(pts.shape[-2], device=pts.device).expand(
        pts.shape[:-1])
    for key in keys:
        perm = torch.gather(perm, -1,
                            stable_argsort(torch.gather(key, -1, perm)))
    return perm


def apply_sentinel(pts: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Overwrite invalid rows with the sentinel coordinate."""
    return torch.where(mask[..., None], pts,
                       torch.full_like(pts, SENTINEL))
