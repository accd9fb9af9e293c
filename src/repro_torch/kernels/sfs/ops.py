"""One-call entry for the fused SFS sweep.

Counterpart of ``repro.kernels.sfs.ops``.  :func:`sfs_sweep` runs the
whole sorted Sort-Filter-Skyline scan for a **batch of partitions** in
one call.  The contract, shared by every implementation and held bit for
bit against the JAX package's ``'perpair'`` and ``'jnp'`` sweeps:

  inputs   (P, npad, d) partitions, each presorted by a strictly monotone
           score with invalid rows holding the sentinel coordinate, plus
           the (P, npad) bool mask; ``npad % block == 0``.
  output   per partition: the window holding the first ``wcap`` skyline
           members in score order, its bool mask, and the total keep
           count as int32 (it may exceed ``wcap``: overflow drops extra
           members, never adds spurious ones).

Implementations, picked by ``repro_torch.kernels.backend``:

  * ``'cuda'``    the hand-written Hopper kernel (kernel.py); CUDA tensors
                  only.
  * ``'torch'``   :func:`sfs_sweep_torch`, the plain version: the blocked
                  sweep of the reference's ``_sweep_one_jnp``, batched over
                  P.  The CPU tests run it, and the kernel is held against
                  it on the card.
  * ``'perpair'`` the per-pair oracle (ref.py), one partition at a time.

``wtile`` is schedule only: the plain version tests the window in tiles
of that many rows, the kernel stages it in tiles of its own size, and
no tile changes a bit.

Subnormal coordinates compare as zeros of their sign, as in XLA on the
CPU, while the window keeps the rows' stored bits: the plain version
tests flushed copies (``dominance.ref.flush_subnormal``) and appends the
rows themselves; the kernel is built with ``--ftz=true``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.backend import KernelSpec, kernel_call, resolve_spec
from repro_torch.kernels.dominance.ref import flush_subnormal
from repro_torch.kernels.sfs import kernel as _kernel
from repro_torch.kernels.sfs import ref as _ref

__all__ = ["sfs_sweep", "sfs_sweep_torch"]

# window rows the plain version tests at once when no tile is asked for;
# bounds its (P, rows, block) temporaries
_WINDOW_CHUNK = 4096


def _dominated_by(refs: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """(P, R, C) bool: ``refs[p, j]`` dominates ``cands[p, i]``."""
    le = torch.ones(refs.shape[:2] + cands.shape[1:2], dtype=torch.bool,
                    device=cands.device)
    lt = torch.zeros_like(le)
    for k in range(cands.shape[-1]):
        rk = refs[:, :, None, k]
        ck = cands[:, None, :, k]
        le &= rk <= ck
        lt |= rk < ck
    return le & lt


def sfs_sweep_torch(pts_s: torch.Tensor, mask_s: torch.Tensor, *,
                    block: int, wcap: int, sentinel: float, wtile: int = 0):
    """The plain sweep of a (P, npad, d) sorted batch.

    Per candidate block: the lower-triangular self-test, the test
    against the live window rows (slots past the count hold the sentinel
    and are inert, so the bound is only the work), and the append at
    ``count + prefix - 1``.  Empty window slots and invalid candidates
    are sentinel-filled, so no validity mask enters a dominance test.
    The tests read a flushed copy of the rows and of the window; the
    window itself receives the rows' stored bits."""
    p, npad, d = pts_s.shape
    dev = pts_s.device
    flushed = flush_subnormal(pts_s)
    # row wcap is a dump slot for the keeps that do not fit
    window = torch.full((p, wcap + 1, d), sentinel, dtype=pts_s.dtype,
                        device=dev)
    window_f = window.clone()
    wmask = torch.zeros((p, wcap + 1), dtype=torch.bool, device=dev)
    count = torch.zeros((p,), dtype=torch.int64, device=dev)
    tri = torch.ones((block, block), dtype=torch.bool, device=dev).triu(1)
    step = wtile or _WINDOW_CHUNK
    for b in range(npad // block):
        x = pts_s[:, b * block:(b + 1) * block]
        xf = flushed[:, b * block:(b + 1) * block]
        xm = mask_s[:, b * block:(b + 1) * block]
        dom = (_dominated_by(xf, xf) & tri).any(dim=1)
        live = int(count.clamp(max=wcap).max()) if p else 0
        for t0 in range(0, live, step):
            w = window_f[:, t0:min(t0 + step, live)]
            dom |= _dominated_by(w, xf).any(dim=1)
        keep = xm & ~dom
        pos = count[:, None] + torch.cumsum(keep, dim=1) - 1
        dest = torch.where(keep & (pos < wcap), pos, wcap)
        window.scatter_(1, dest[..., None].expand(-1, -1, d), x)
        window_f.scatter_(1, dest[..., None].expand(-1, -1, d), xf)
        wmask.scatter_(1, dest, keep)
        count += keep.sum(dim=1)
    return (window[:, :wcap].contiguous(), wmask[:, :wcap].contiguous(),
            count.to(torch.int32))


def _normalize_wtile(wtile: int, wcap: int, block: int) -> int:
    """Window-tile normalisation, the reference's rule: <= 0 means
    untiled; tiles are clamped to the window and must divide it, and a
    non-divisor falls back to ``block`` (which divides ``wcap`` in every
    caller), or to untiled as the last resort."""
    wtile = int(wtile)
    if wtile <= 0:
        return 0
    if wtile >= wcap:
        return wcap
    if wcap % wtile != 0:
        return block if wcap % block == 0 else 0
    return wtile


def sfs_sweep(pts_s: torch.Tensor, mask_s: torch.Tensor, *, block: int,
              wcap: int, sentinel: float, wtile: int = 0,
              spec: KernelSpec | str = "auto"):
    """Fused SFS sweep of a (P, npad, d) sorted batch.

    Returns ``(window (P, wcap, d), wmask (P, wcap) bool, count (P,)
    int32)``; see the module docstring for the contract."""
    if pts_s.ndim != 3 or tuple(mask_s.shape) != tuple(pts_s.shape[:2]):
        raise ValueError(f"expected (P, npad, d)/(P, npad), got "
                         f"{tuple(pts_s.shape)}/{tuple(mask_s.shape)}")
    if pts_s.shape[1] % block != 0:
        raise ValueError(f"npad={pts_s.shape[1]} not a multiple of "
                         f"block={block}")
    spec = resolve_spec(spec, pts_s.device)
    d = pts_s.shape[2]
    if spec.max_d is not None and d > spec.max_d:
        raise ValueError(f"d={d} > {spec.max_d} not supported by the "
                         f"{spec.name!r} backend; use impl='torch'")
    wtile = _normalize_wtile(wtile, wcap, block)
    kw = dict(block=block, wcap=wcap, sentinel=sentinel)
    if spec.sweep == "cuda":
        fn = _kernel.sfs_sweep_cuda
    elif spec.sweep == "torch":
        fn, kw["wtile"] = sfs_sweep_torch, wtile
    else:
        fn = _sweep_perpair
    return kernel_call("sfs_sweep", spec.sweep, fn, pts_s, mask_s, **kw)


def _sweep_perpair(pts_s, mask_s, *, block: int, wcap: int,
                   sentinel: float):
    """The per-pair oracle, one partition at a time."""
    outs = [_ref.sfs_sweep_perpair(pts_s[i], mask_s[i], block=block,
                                   wcap=wcap, sentinel=sentinel)
            for i in range(pts_s.shape[0])]
    return tuple(torch.stack(leaf) for leaf in zip(*outs))
