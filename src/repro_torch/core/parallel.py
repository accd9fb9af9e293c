"""Parallel skyline computation (paper Algorithm 2) on one device.

Counterpart of ``repro.core.parallel`` with ``mesh=None``.  The three
phases:

  partition  the SLICED id map and `bucketize` routing into (p, C, d)
             buckets;
  local      per-partition block-SFS: ONE sweep launch over all p
             partitions (`repro_torch.core.sfs.local_skyline_batch`);
  merge      the paper's sequential pass: compact the union of the local
             skylines and run the same sweep on it (a second launch, one
             partition), then put the members in the canonical order.

So a query makes two sweep launches.  Shapes depend only on the input
size and the config, so the pipeline never waits on the device between
stages.

This slice ports the default configuration.  The random, grid and
angular strategies, representative filtering, NoSeq, the tree merge and
the multi-device mesh raise ``NotImplementedError`` naming their item of
ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import partition
from repro_torch.core.dominance import canonical_order
from repro_torch.core.sfs import (SkyBuffer, block_sfs, compact,
                                  local_skyline_batch)
from repro_torch.kernels.backend import resolve_device

__all__ = ["SkyConfig", "parallel_skyline", "effective_parts",
           "partition_stage", "local_stage", "compact_union", "merge_stage",
           "as_inputs"]


@dataclasses.dataclass(frozen=True)
class SkyConfig:
    """Configuration of the parallel skyline pipeline: the reference's
    fields and defaults, so a reference config converts field for field
    (``repro_torch.convert.config_from_reference``)."""
    strategy: str = "sliced"      # random | grid | angular | sliced
    p: int = 8                    # target #partitions (grid/angular: derived)
    m: int = 0                    # slices/dim (grid/angular); 0 = derive from p
    bucket_factor: float = 1.0    # bucket capacity = factor * ceil(n/p)
    bucket_capacity: int = 0      # explicit override (0 = use factor)
    local_capacity: int = 0       # phase-1 window capacity (0 = bucket cap)
    capacity: int = 4096          # final skyline buffer capacity
    block: int = 256              # dominance-test block size
    wtile: int = 0                # sweep window tile (0 = whole window)
    rep_filter: str | None = None  # None | sorted | region | random
    rep_k: int = 16               # representatives per partition
    noseq: bool = False           # parallel phase 2 (paper §4.2)
    grid_filter: bool = True      # grid-only pre-filter (paper §3.2)
    sliced_dim: int = 0
    impl: str = "auto"            # kernel backend (repro_torch.kernels.backend)
    merge: str = "flat"           # union merge topology: flat | tree | auto
    donate: bool = True           # reference's buffer donation; no effect
    #                               on the one-shot path


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet; see ROADMAP.md, 'Modules still to "
        f"port', item {item}")


def check_supported(cfg: SkyConfig, mesh=None) -> None:
    """Raise for every part of the config this port does not run yet."""
    if cfg.strategy not in ("random", "grid", "angular", "sliced"):
        raise ValueError(f"unknown strategy {cfg.strategy!r}")
    if cfg.strategy != "sliced":
        raise _not_ported(f"strategy {cfg.strategy!r}", "4a")
    if cfg.rep_filter:
        raise _not_ported("representative filtering", "4b")
    if cfg.noseq:
        raise _not_ported("the NoSeq merge", "4c")
    if cfg.merge not in ("flat", "tree", "auto"):
        raise ValueError(f"unknown merge mode {cfg.merge!r} "
                         f"(expected flat | tree | auto)")
    if cfg.merge == "tree":
        raise _not_ported("the tree merge", "4d")
    if mesh is not None:
        raise _not_ported("the multi-device mesh", "8")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def effective_parts(cfg: SkyConfig, d: int) -> tuple[int, int]:
    """(p, m) actually used, honouring grid/angular constraints."""
    if cfg.strategy == "grid":
        m = cfg.m or partition.slices_for_target_parts(cfg.p, d)
        return partition.grid_num_parts(m, d), m
    if cfg.strategy == "angular":
        m = cfg.m or partition.slices_for_target_parts(cfg.p, max(d - 1, 1))
        return partition.angular_num_parts(m, d), m
    return cfg.p, 0


def partition_stage(pts: torch.Tensor, mask: torch.Tensor, cfg: SkyConfig):
    """Partition-id map + routing into (p, C, d) buckets."""
    check_supported(cfg)
    n, d = pts.shape
    p, _ = effective_parts(cfg, d)
    ids = partition.sliced_part_ids(pts, mask, p, cfg.sliced_dim)
    cap = cfg.bucket_capacity or max(
        1, int(cfg.bucket_factor * _ceil_div(n, p)) + 1)
    buckets = partition.bucketize(pts, mask, ids, p, cap)
    stats: dict[str, Any] = {
        "bucket_counts": buckets.counts,
        "bucket_overflow": buckets.overflow,
        "n_valid": mask.sum().to(torch.int32),
    }
    return buckets, stats


def local_stage(bufs: torch.Tensor, bmask: torch.Tensor, cfg: SkyConfig):
    """Phase 1: the whole partition batch through ONE sweep launch."""
    check_supported(cfg)
    local_cap = cfg.local_capacity or bufs.shape[1]
    sky = local_skyline_batch(bufs, bmask, capacity=local_cap,
                              block=cfg.block, impl=cfg.impl,
                              wtile=cfg.wtile)
    return sky, {"local_sizes": sky.count, "local_overflow": sky.overflow.any()}


def compact_union(sky: SkyBuffer, cfg: SkyConfig) -> SkyBuffer:
    """The union of the local skylines, valid rows first, truncated to
    the capacity: the final pass scans |union| tuples, not p x capacity
    padded rows."""
    flat = sky.points.reshape(-1, sky.points.shape[-1])
    return compact(flat, sky.mask.reshape(-1),
                   min(flat.shape[0], max(cfg.capacity, 1)))


def merge_stage(sky: SkyBuffer, cfg: SkyConfig):
    """Phase 2, the flat sequential merge: compact the union of the local
    skylines, sweep it (the second launch), and canonicalise."""
    check_supported(cfg)
    u_compact = compact_union(sky, cfg)
    final = block_sfs(u_compact.points, u_compact.mask,
                      capacity=cfg.capacity, block=cfg.block, impl=cfg.impl,
                      wtile=cfg.wtile)
    # block-SFS breaks score ties by input order; the total canonical
    # order makes the output independent of how the data reached it
    order = canonical_order(final.points, final.mask)
    final = SkyBuffer(final.points[order], final.mask[order], final.count,
                      final.overflow | u_compact.overflow)
    return final, {"union_size": sky.mask.sum().to(torch.int32)}


def as_inputs(pts, mask, device):
    """``(pts, mask)`` as float32 and bool tensors on the entry points'
    device (:func:`repro_torch.kernels.backend.resolve_device`)."""
    device = resolve_device(device)
    pts = torch.as_tensor(pts, device=device).to(torch.float32)
    if mask is not None:
        mask = torch.as_tensor(mask, device=device).bool()
    return pts, mask


def _local_merge(bufs, bmask, *, cfg: SkyConfig):
    """One query's phase 1 + phase 2."""
    sky, s2 = local_stage(bufs, bmask, cfg)
    final, s3 = merge_stage(sky, cfg)
    return final, dict(s2, **s3)


def parallel_skyline(pts, mask=None, *, cfg: SkyConfig = SkyConfig(),
                     mesh=None, device=None):
    """Compute SKY(pts) with the parallel pattern of the paper.

    ``pts`` is an (N, d) array or tensor and ``mask`` an optional (N,)
    validity mask; both are moved to ``device``, which is the card unless
    the caller passes ``device="cpu"`` (without CUDA that raises
    ``RuntimeError``).  Returns ``(SkyBuffer, stats)``, every leaf a
    tensor on that device."""
    from repro_torch.core import incremental
    check_supported(cfg, mesh)
    pts, mask = as_inputs(pts, mask, device)
    if mask is None:
        mask = torch.ones((pts.shape[0],), dtype=torch.bool,
                          device=pts.device)
    state, stats = incremental._insert(None, pts, mask, cfg=cfg)
    return SkyBuffer(state.points, state.mask, state.count,
                     state.overflow), stats
