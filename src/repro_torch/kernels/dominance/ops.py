"""One-call entry for the pairwise dominance test.

Counterpart of ``repro.kernels.dominance.ops``: the ONE call for
dominance between two (possibly different) point sets.  The streaming
pre-filter and eviction, representative selection and filtering, NoSeq's
relative skylines and ``skyline_mask`` all go through it; the local SFS
scan does not (that is the fused sweep, ``repro_torch.kernels.sfs``).

The contract, shared by every implementation and held bit for bit
against the JAX package's ``'jnp'`` and ``'interpret'`` paths::

    dominated_mask(cands, refs, ref_mask=None, *, lower_tri=False)

``out[..., i] = any_j ref_mask[..., j] & (refs[..., j] dominates
cands[..., i])``; with ``lower_tri`` only refs with ``j < i`` count.
Unlike the reference, the entry takes an optional **leading batch
axis**: cands (B, C, d), refs (B, R, d) or (R, d), mask (B, R) or (R,).
References and mask given without the batch axis, or expanded over it
(batch stride 0), are shared by every batch: one launch does what the
reference's ``vmap`` over partitions or queries does.

Implementations, picked by ``repro_torch.kernels.backend``:

  * ``'cuda'``   the hand-written Hopper kernel (kernel.py); CUDA tensors
                 only.
  * ``'torch'``  :func:`dominated_mask_torch`, the plain version, blocked
                 over candidates and references.  The CPU tests run it,
                 and the kernel is held against it on the card.

bfloat16 inputs are widened to float32 first: the widening is exact and
keeps the order, so no bit of the answer changes.  Subnormal coordinates
compare as zeros of their sign, as in XLA on the CPU: the plain version
compares flushed copies (``ref.flush_subnormal``), the kernel is built
with ``--ftz=true``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.backend import kernel_call
from repro_torch.kernels.dominance import kernel as _kernel
from repro_torch.kernels.dominance.ref import flush_subnormal

__all__ = ["dominated_mask", "dominated_mask_torch"]

# elements of the plain version's (B, cands, refs) temporaries, and the
# reference rows it tests at once
_PAIR_BUDGET = 1 << 26
_REF_BLOCK = 4096


def _last_valid_row(ref_mask: torch.Tensor) -> int:
    """1 + the last row that is valid in some batch (0 when none)."""
    live = ref_mask.any(dim=0)
    rows = torch.arange(1, live.shape[0] + 1, device=live.device)
    return int(torch.where(live, rows, 0).max()) if live.numel() else 0


def dominated_mask_torch(cands: torch.Tensor, refs: torch.Tensor,
                         ref_mask: torch.Tensor, *,
                         lower_tri: bool = False) -> torch.Tensor:
    """The plain dominance test of a (B, C, d) batch against (B, R, d)
    references and their (B, R) mask.

    Blocked over references (``_REF_BLOCK`` rows) and candidates (so a
    (B, cands, refs) temporary holds at most ``_PAIR_BUDGET`` elements);
    the result is an OR, so the blocking changes no bit.  References past
    the last row that is valid in some batch are not tested: they could
    not set a bit (one host sync).  Coordinates are compared flushed
    (:func:`flush_subnormal`); references shared by every batch (batch
    stride 0) are flushed once."""
    b, c, d = cands.shape
    cands = flush_subnormal(cands)
    if b > 1 and refs.stride(0) == 0:
        refs = flush_subnormal(refs[:1]).expand(refs.shape)
    else:
        refs = flush_subnormal(refs)
    out = torch.zeros((b, c), dtype=torch.bool, device=cands.device)
    r_end = _last_valid_row(ref_mask)
    if lower_tri:
        r_end = min(r_end, max(c - 1, 0))
    if c == 0 or r_end == 0:
        return out
    rb = min(r_end, _REF_BLOCK)
    cb = max(1, _PAIR_BUDGET // (b * rb))
    for c0 in range(0, c, cb):
        c1 = min(c0 + cb, c)
        x = cands[:, c0:c1, None, :]                         # (B, cb, 1, d)
        acc = out[:, c0:c1]
        for r0 in range(0, min(r_end, c1 - 1) if lower_tri else r_end, rb):
            r1 = min(r0 + rb, r_end)
            r = refs[:, None, r0:r1, :]                      # (B, 1, rb, d)
            le = r[..., 0] <= x[..., 0]
            lt = r[..., 0] < x[..., 0]
            for k in range(1, d):
                le &= r[..., k] <= x[..., k]
                lt |= r[..., k] < x[..., k]
            dom = le & lt & ref_mask[:, None, r0:r1]
            if lower_tri:
                j = torch.arange(r0, r1, device=cands.device)
                i = torch.arange(c0, c1, device=cands.device)
                dom &= j[None, :] < i[:, None]
            acc |= dom.any(dim=-1)
    return out


def _widen(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.dtype == torch.bfloat16 else x


def dominated_mask(cands: torch.Tensor, refs: torch.Tensor,
                   ref_mask: torch.Tensor | None = None, *,
                   lower_tri: bool = False,
                   impl: str = "auto") -> torch.Tensor:
    """(C,) or (B, C) bool: is each candidate dominated by a valid ref?

    ``impl`` is the dominance family's string (``'cuda'`` | ``'torch'``)
    or ``'auto'``, which follows where the candidates lie.  ``'cuda'`` on
    data elsewhere than on the card raises."""
    batched = cands.ndim == 3
    if cands.ndim not in (2, 3) or refs.ndim not in (2, cands.ndim):
        raise ValueError(f"expected cands (C, d) or (B, C, d) and refs "
                         f"(R, d) or (B, R, d); got {tuple(cands.shape)} "
                         f"and {tuple(refs.shape)}")
    if not batched:
        cands = cands[None]
    b, _, d = cands.shape
    r = refs.shape[-2]
    if refs.shape[-1] != d:
        raise ValueError(f"cands have d={d}, refs d={refs.shape[-1]}")
    if ref_mask is None:
        ref_mask = torch.ones((r,), dtype=torch.bool, device=refs.device)
    if ref_mask.shape[-1] != r or ref_mask.ndim not in (1, 2):
        raise ValueError(f"ref_mask {tuple(ref_mask.shape)} does not fit "
                         f"refs {tuple(refs.shape)}")
    if not batched and ref_mask.ndim == 2:
        raise ValueError("a batched mask needs batched cands")
    refs = refs.expand(b, r, d)
    ref_mask = ref_mask.bool().expand(b, r)
    cands, refs = _widen(cands), _widen(refs)
    if cands.dtype != refs.dtype:
        raise ValueError(f"cands are {cands.dtype}, refs {refs.dtype}")

    if impl == "auto":
        impl = "cuda" if cands.device.type == "cuda" else "torch"
    if impl == "cuda":
        if cands.device.type != "cuda":
            raise ValueError(f"impl 'cuda' runs on CUDA tensors only; got "
                             f"data on {cands.device}")
        if d > _kernel.D_MAX:
            raise ValueError(f"d={d} > {_kernel.D_MAX} not supported by the "
                             f"'cuda' dominance kernel; use impl='torch'")
        # the kernel reads rows in place, with any batch stride; other
        # layouts are copied first
        if refs.stride(-1) != 1 or (d > 1 and refs.stride(-2) != d):
            refs = refs.contiguous()
        if ref_mask.stride(-1) != 1:
            ref_mask = ref_mask.contiguous()
        out = kernel_call("dominated_mask", impl,
                          _kernel.dominated_mask_cuda, cands.contiguous(),
                          refs, ref_mask, lower_tri=lower_tri)
    elif impl == "torch":
        out = kernel_call("dominated_mask", impl, dominated_mask_torch,
                          cands, refs, ref_mask, lower_tri=lower_tri)
    else:
        raise ValueError(f"unknown dominance impl {impl!r}; one of "
                         f"'cuda', 'torch' or 'auto'")
    return out if batched else out[0]
