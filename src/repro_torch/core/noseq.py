"""NoSeq (paper §4.2): the fully parallel second phase.

Counterpart of ``repro.core.noseq``: ``pd_row_mask``,
``relative_skyline_mask`` and the tree merge's per-row
``relative_rows_mask``.  After phase 1, with u the union of
the local skylines u_i, worker i removes its globally dominated tuples by
testing u_i only against its *potential dominators* pd_i, a subset of
u \\ u_i (Proposition 2):

  RANDOM / ANGULAR : pd_i = u \\ u_i
  SLICED           : pd_i = { u_j : j < i }
  GRID             : pd_i = { u_j : c_j <=_G c_i }

Here every partition is filtered in one dominance launch: the union is
shared by all of them, and each gets its own potential-dominator mask.
The tree merge's buffers mix rows of many partitions, so there the
relation is evaluated per row pair (``relative_rows_mask``): plain
torch, as the reference's ``lax.map`` is plain XLA, not a kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core.dominance import dominated_mask, flush_subnormal

__all__ = ["pd_row_mask", "relative_skyline_mask", "relative_rows_mask"]


def pd_row_mask(strategy: str, own_part, ref_parts: torch.Tensor,
                own_cell: torch.Tensor | None = None,
                ref_cells: torch.Tensor | None = None) -> torch.Tensor:
    """Which gathered rows are potential dominators for the worker that
    owns partition ``own_part``.

    ``own_part`` may carry leading axes S (one worker per entry), with
    ``own_cell`` of shape S + (d,); the result is S + (R,)."""
    own = torch.as_tensor(own_part, device=ref_parts.device).unsqueeze(-1)
    not_self = ref_parts != own
    if strategy in ("random", "angular"):
        return not_self
    if strategy == "sliced":
        return ref_parts < own
    if strategy == "grid":
        if own_cell is None or ref_cells is None:
            raise ValueError("the grid strategy needs cells")
        weak = (ref_cells <= own_cell.unsqueeze(-2)).all(dim=-1)
        return weak & not_self
    raise ValueError(f"unknown strategy {strategy!r}")


def relative_skyline_mask(u_i: torch.Tensor, mask_i: torch.Tensor,
                          refs: torch.Tensor, ref_mask: torch.Tensor,
                          pd_mask: torch.Tensor, *,
                          impl: str = "auto") -> torch.Tensor:
    """SKY_{pd_i}(u_i) membership mask (paper Definition 4); with a
    leading axis on ``u_i``, ``mask_i`` and ``pd_mask``, every worker in
    one launch."""
    dom = dominated_mask(u_i, refs, ref_mask & pd_mask, impl=impl)
    return mask_i & ~dom


def relative_rows_mask(pts: torch.Tensor, mask: torch.Tensor,
                       parts: torch.Tensor, cells: torch.Tensor, *,
                       strategy: str, block: int = 256) -> torch.Tensor:
    """Per-ROW relative-skyline mask of a mixed-origin buffer (R, d), or
    (Q, R, d) for Q buffers, each row with its partition ``parts`` (R,)
    and grid cell ``cells`` (R, d).

    The potential-dominator relation of `pd_row_mask` is evaluated per
    (candidate row, reference row) pair, and candidates walk in blocks
    of ``block`` rows, as the reference's ``lax.map`` does, keeping the
    pairwise footprint at O(block x R).  Comparisons flush subnormals
    as XLA does.  The sliced predicate is the reference's
    ``ref_part < own_part``, ties across a slice boundary included
    (ROADMAP.md, queue 3)."""
    if pts.ndim == 2:
        return relative_rows_mask(pts[None], mask[None], parts[None],
                                  cells[None], strategy=strategy,
                                  block=block)[0]
    if strategy not in ("random", "angular", "sliced", "grid"):
        raise ValueError(f"unknown strategy {strategy!r}")
    r, d = pts.shape[1], pts.shape[2]
    b = min(block, max(r, 1))
    # one (Q, R) row per coordinate, so that each block's tests are
    # (Q, b, R) planes, never a (Q, b, R, d) tensor
    f = flush_subnormal(pts).permute(2, 0, 1)[:, :, None, :]
    g = cells.permute(2, 0, 1)[:, :, None, :]
    out = []
    for lo in range(0, r, b):
        xp = parts[:, lo:lo + b, None]
        if strategy == "sliced":
            cand = parts[:, None, :] < xp                  # (Q, b, R)
        else:
            cand = parts[:, None, :] != xp
            if strategy == "grid":
                for k in range(d):
                    cand &= g[k] <= g[k][:, 0, lo:lo + b, None]
        cand &= mask[:, None, :]
        lt = torch.zeros_like(cand)
        for k in range(d):
            xk = f[k][:, 0, lo:lo + b, None]
            cand &= f[k] <= xk
            lt |= f[k] < xk
        out.append(mask[:, lo:lo + b] & ~(cand & lt).any(dim=-1))
    return torch.cat(out, dim=1)
