"""Public skyline API of the port.

Counterpart of ``repro.core.api``: `skyline` / `skyline_mask_exact` are
the sequential entry points, `parallel_skyline` runs partition -> local
-> merge (``repro_torch.core.parallel``), and `init_state` /
`insert_chunk` / `finalize` (``repro_torch.core.incremental``) keep a
running skyline whose snapshot is bit for bit the one-shot answer.
Sliding windows live in ``repro_torch.core.windowed`` and the paper's
real datasets in ``repro_torch.core.datagen.load_real``, as in the
reference.  Every entry point runs on the card unless the caller passes
``device="cpu"`` (the streaming calls run where their state lies);
without CUDA it raises ``RuntimeError`` rather than moving to the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.core.dominance import SENTINEL
from repro_torch.core.incremental import (SkylineState, finalize, init_state,
                                          insert_chunk)
from repro_torch.core.parallel import SkyConfig, parallel_skyline
from repro_torch.core.sfs import (SkyBuffer, as_inputs, block_sfs,
                                  naive_skyline_mask, skyline_mask)

__all__ = ["skyline", "skyline_mask_exact", "skyline_mask",
           "parallel_skyline", "SkyConfig", "SkyBuffer", "SkylineState",
           "init_state", "insert_chunk", "finalize"]


def skyline(pts, mask=None, *, capacity: int | None = None, block: int = 256,
            impl: str = "auto", wtile: int = 0, device=None) -> SkyBuffer:
    """Sequential skyline via block-SFS (paper Algorithm 1).

    ``n == 0`` (or ``capacity=0``) returns an empty buffer instead of
    sweeping a zero-row window; all-masked inputs give ``count == 0``."""
    pts, mask = as_inputs(pts, mask, device)
    n, d = pts.shape
    cap = n if capacity is None else capacity
    if n == 0 or cap == 0:
        cap = max(cap, 1)
        return SkyBuffer(
            torch.full((cap, d), SENTINEL, dtype=pts.dtype,
                       device=pts.device),
            torch.zeros((cap,), dtype=torch.bool, device=pts.device),
            torch.zeros((), dtype=torch.int32, device=pts.device),
            torch.zeros((), dtype=torch.bool, device=pts.device))
    return block_sfs(pts, mask, capacity=cap, block=block, impl=impl,
                     wtile=wtile)


def skyline_mask_exact(pts, mask=None, *, device=None) -> torch.Tensor:
    """O(N^2) oracle membership mask (tests and small inputs)."""
    pts, mask = as_inputs(pts, mask, device)
    return naive_skyline_mask(pts, mask)
