"""Skyline-based data curation: the Pareto front of training examples.

Counterpart of ``repro.data.selection``, bit for bit.  Each example gets
a criteria vector (smaller = better on every axis, e.g. [-loss, -length,
staleness]); the Pareto front (the skyline) is the set of examples no
other beats on every criterion at once, a multi-criteria alternative to
single-score heuristics for hard-example mining and data pruning.

The arithmetic is the reference's on XLA:CPU: the min-max normalisation
runs in f32 with every operand and result flushed
(`repro_torch.core.dominance.flush_subnormal`), the score sums the
criteria left to right from +0.0 (`monotone_score`), and the ranking is
a stable sort that ranks signed zeros equal.  The membership test is one
dominance launch of the criteria against themselves
(`repro_torch.core.sfs.skyline_mask`).

The entry points run on the card unless given ``device="cpu"``.
"""

from __future__ import annotations

import torch

from repro_torch.core.dominance import (flush_subnormal, monotone_score,
                                        reduce_max, reduce_min,
                                        stable_argsort)
from repro_torch.core.parallel import SkyConfig, parallel_skyline
from repro_torch.core.sfs import skyline_mask
from repro_torch.kernels.backend import resolve_device

__all__ = ["pareto_mask", "pareto_select", "example_criteria"]


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float32)


def _normalize(criteria: torch.Tensor) -> torch.Tensor:
    """Per-column min-max normalisation, ``(c - lo) / max(hi - lo,
    1e-9)``, flushed as XLA does."""
    c = flush_subnormal(criteria)
    lo = reduce_min(c, 0)
    hi = reduce_max(c, 0)
    den = torch.maximum(flush_subnormal(hi - lo),
                        torch.tensor(1e-9, dtype=torch.float32,
                                     device=c.device))
    return flush_subnormal(flush_subnormal(c - lo) / den)


def pareto_mask(criteria, *, distributed_cfg: SkyConfig | None = None,
                mesh=None, device=None, impl: str = "auto") -> torch.Tensor:
    """(N,) bool: membership of each example in the Pareto front.

    ``criteria`` is (N, d), smaller = better.  With ``distributed_cfg``
    the full parallel pipeline (partition, local, merge) runs too, on
    ``mesh`` when one is given, and the answer is still the blocked
    membership test, as in the reference, which discards its
    distributed result (ROADMAP queue 3).  ``impl`` picks the dominance
    test's backend (`repro_torch.kernels.backend`; the reference has no
    such argument)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    c = _normalize(_f32(criteria, dev))
    if distributed_cfg is not None:
        parallel_skyline(c, cfg=distributed_cfg, mesh=mesh, device=dev)
    return skyline_mask(c, impl=impl, device=dev)


def pareto_select(criteria, k: int, *, device=None, impl: str = "auto"):
    """Indices of up to k examples, Pareto-front members first (front
    members get priority 0, dominated examples are ranked by a monotone
    score), and the front mask.  The indices are int32."""
    c = _normalize(_f32(criteria, resolve_device(device)))
    front = pareto_mask(c, device=c.device, impl=impl)
    score = flush_subnormal(monotone_score(c) + torch.where(
        front, torch.zeros_like(c[:, 0]), torch.full_like(c[:, 0], 1e3)))
    order = stable_argsort(score).to(torch.int32)
    return order[:k], front


def example_criteria(per_example_loss, lengths, recency, *,
                     device=None) -> torch.Tensor:
    """A standard criteria vector: prefer hard (high-loss), long-enough,
    fresh examples, every axis mapped to smaller-is-better in [0, 1]."""
    dev = resolve_device(device)
    hard = -_f32(per_example_loss, dev)        # harder = smaller
    short = -_f32(lengths, dev)
    stale = _f32(recency, dev)
    return _normalize(torch.stack([hard, short, stale], dim=-1))
