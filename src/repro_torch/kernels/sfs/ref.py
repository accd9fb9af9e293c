"""Per-pair oracle for the SFS sweep.

Counterpart of ``repro.kernels.sfs.ref``: the seed ``block_sfs`` scan,
which tests each candidate block against the window one window block at
a time and against its own earlier rows, all through the dominance
oracle.  It is the port's own bit-for-bit reference for the sweep.

The contract is that of :func:`repro_torch.kernels.sfs.ops.sfs_sweep`:
inputs are score-sorted, sentinel-filled, block-padded partitions; the
output is the packed window (first ``wcap`` skyline members in score
order), its validity mask, and the total keep count (which may exceed
``wcap`` under overflow: extra members are dropped, never spurious ones
added).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dominance.ref import dominated_mask_ref

__all__ = ["sfs_sweep_perpair"]


def sfs_sweep_perpair(pts_s: torch.Tensor, mask_s: torch.Tensor, *,
                      block: int, wcap: int, sentinel: float):
    """Per-pair SFS scan of ONE sorted partition.

    Args:
      pts_s: (npad, d) rows presorted by a strictly monotone score,
        invalid rows holding the sentinel coordinate; npad % block == 0.
      mask_s: (npad,) bool row validity, same order.
      block: dominance-test block size.
      wcap: window rows.
      sentinel: fill value for empty window slots.

    Returns:
      ``(window (wcap, d), wmask (wcap,) bool, count () int32)``.
    """
    npad, d = pts_s.shape
    dev = pts_s.device
    window = torch.full((wcap, d), sentinel, dtype=pts_s.dtype, device=dev)
    wmask = torch.zeros((wcap,), dtype=torch.bool, device=dev)
    count = 0
    for b in range(npad // block):
        x = pts_s[b * block:(b + 1) * block]
        xm = mask_s[b * block:(b + 1) * block]
        dom = dominated_mask_ref(x, x, xm, lower_tri=True)
        for wb in range(min(-(-count // block), wcap // block)):
            sl = slice(wb * block, (wb + 1) * block)
            dom |= dominated_mask_ref(x, window[sl], wmask[sl])
        keep = xm & ~dom
        pos = count + torch.cumsum(keep.to(torch.int64), 0) - 1
        put = keep & (pos < wcap)
        window[pos[put]] = x[put]
        wmask[pos[put]] = True
        count += int(keep.sum())
    return window, wmask, torch.tensor(count, dtype=torch.int32, device=dev)
