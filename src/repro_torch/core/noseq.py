"""NoSeq (paper §4.2): the fully parallel second phase.

Counterpart of ``repro.core.noseq`` (``pd_row_mask`` and
``relative_skyline_mask``; the per-row ``relative_rows_mask`` comes with
the tree merge across devices, ROADMAP.md item 8).  After phase 1, with u the union of
the local skylines u_i, worker i removes its globally dominated tuples by
testing u_i only against its *potential dominators* pd_i, a subset of
u \\ u_i (Proposition 2):

  RANDOM / ANGULAR : pd_i = u \\ u_i
  SLICED           : pd_i = { u_j : j < i }
  GRID             : pd_i = { u_j : c_j <=_G c_i }

Here every partition is filtered in one dominance launch: the union is
shared by all of them, and each gets its own potential-dominator mask.
"""

from __future__ import annotations

import torch

from repro_torch.core.dominance import dominated_mask

__all__ = ["pd_row_mask", "relative_skyline_mask"]


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
