"""Plain-torch oracle for pairwise dominance.

Dominance: ``t < s`` (t dominates s) iff ``all_k t[k] <= s[k]`` and
``any_k t[k] < s[k]``.

    dominated_mask_ref(cands, refs, ref_mask, lower_tri=False) -> (C,) bool

``out[i] = any_j ref_mask[j] & (refs[j] < cands[i])`` and, when
``lower_tri`` is set (self-join on a score-sorted array), only refs with
``j < i`` count — sound because a strictly increasing score puts every
dominator strictly earlier.

Counterpart of ``repro.kernels.dominance.ref``: the oracle of the
blocked dominance entry (``ops.dominated_mask``), of the sweep and of the
O(N^2) membership mask.  Coordinates are compared as XLA compares them
on the CPU: a subnormal operand counts as a zero of its sign
(:func:`flush_subnormal`).
"""

from __future__ import annotations

import torch

__all__ = ["flush_subnormal", "dominance_matrix_ref", "dominated_mask_ref"]


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every subnormal value replaced by a zero of its sign,
    as XLA on the CPU (and a TPU) treats f32 operands and results; zeros,
    normal numbers, infinities and NaN are kept bit for bit.  Integer
    and bool tensors are returned as they are."""
    if not x.is_floating_point():
        return x
    return torch.where(x.abs() < torch.finfo(x.dtype).tiny, x * 0.0, x)


def dominance_matrix_ref(refs: torch.Tensor,
                         cands: torch.Tensor) -> torch.Tensor:
    """(R, C) bool matrix: ``out[j, i] = refs[j] dominates cands[i]``.

    Built one attribute at a time, so the largest temporary is (R, C)."""
    refs, cands = flush_subnormal(refs), flush_subnormal(cands)
    r, c = refs.shape[0], cands.shape[0]
    le = torch.ones((r, c), dtype=torch.bool, device=cands.device)
    lt = torch.zeros((r, c), dtype=torch.bool, device=cands.device)
    for k in range(cands.shape[1]):
        rk = refs[:, k, None]
        ck = cands[None, :, k]
        le &= rk <= ck
        lt |= rk < ck
    return le & lt


def dominated_mask_ref(cands: torch.Tensor, refs: torch.Tensor,
                       ref_mask: torch.Tensor | None = None, *,
                       lower_tri: bool = False) -> torch.Tensor:
    """Per candidate: is it dominated by any valid reference row?

    Args:
      cands: (C, d) candidate points.
      refs: (R, d) reference points.
      ref_mask: (R,) validity of each reference row (None = all valid).
      lower_tri: ref j may only dominate cand i when ``j < i``.

    Returns:
      (C,) bool, True where the candidate is dominated.
    """
    dom = dominance_matrix_ref(refs, cands)
    if ref_mask is not None:
        dom &= ref_mask[:, None]
    if lower_tri:
        j = torch.arange(refs.shape[0], device=cands.device)
        i = torch.arange(cands.shape[0], device=cands.device)
        dom &= j[:, None] < i[None, :]
    return dom.any(dim=0)
