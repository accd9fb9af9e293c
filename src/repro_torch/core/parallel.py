"""Parallel skyline computation (paper Algorithm 2) on one device.

Counterpart of ``repro.core.parallel`` with ``mesh=None``.  The three
phases:

  partition  the partition-id map of the strategy (random, grid with
             optional Grid Filtering, angular or sliced) and `bucketize`
             routing into (p, C, d) buckets, beside the reference's
             ``meta`` (p, m, each partition's grid cell and index);
  local      optional Representative Filtering (paper §4.1: pick
             ``rep_k`` representatives per partition, drop the dominated
             ones from the shared pool, filter every partition against
             it; three dominance launches), then per-partition block-SFS:
             ONE sweep launch over all p partitions
             (`repro_torch.core.sfs.local_skyline_batch`);
  merge      the paper's sequential pass (compact the union of the local
             skylines and run the same sweep on it: a second launch, one
             partition), or NoSeq (paper §4.2: every partition's local
             skyline against its potential dominators in the compacted
             union, one dominance launch for all p); then the members go
             into the canonical order.

Every stage takes an optional leading query axis Q: the partition
stage routes the Q queries with one sort along N for all of them, and
the local and merge stages flatten Q x p into the sweep's partition
axis and into the dominance kernel's batch axis, so Q queries cost the
launches of one (`fused_skyline_batch_fn`, the engine's pipeline, and
the streaming batch insert of `repro_torch.core.incremental`).  The
random draws are the exception: ``strategy='random'`` draws one
permutation and ``rep_filter='random'`` one set of uniforms per query,
from that query's own generator, so their operations grow with Q.  Shapes
depend only on the input size and the config; the plain versions sync
with the host, the kernels do not.

``merge='tree'`` without a mesh runs the flat merge, as the reference
does without a workers axis (the merge mode changes the collective
schedule, never the bits).  The multi-device mesh, and with it the tree
schedule across devices, raises ``NotImplementedError`` naming its item
of ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import filtering, noseq, partition
from repro_torch.core.dominance import canonical_order, dominated_mask
from repro_torch.core.sfs import (SkyBuffer, as_inputs, compact,
                                  compact_order, gather_rows,
                                  local_skyline_batch)
from repro_torch.kernels.backend import resolve_spec

__all__ = ["SkyConfig", "parallel_skyline", "fused_skyline_batch_fn",
           "effective_parts",
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
    donate: bool = True           # buffer donation: inserts and window ops
    #                               write the caller's state in place


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet; see ROADMAP.md, 'Modules still to "
        f"port', item {item}")


def check_supported(cfg: SkyConfig, mesh=None) -> None:
    """Raise for every part of the config this port does not run yet:
    the multi-device mesh (with it the tree merge across devices)."""
    if cfg.strategy not in ("random", "grid", "angular", "sliced"):
        raise ValueError(f"unknown strategy {cfg.strategy!r}")
    if cfg.merge not in ("flat", "tree", "auto"):
        raise ValueError(f"unknown merge mode {cfg.merge!r} "
                         f"(expected flat | tree | auto)")
    if mesh is not None:
        what = ("the tree merge across devices" if cfg.merge == "tree"
                else "the multi-device mesh")
        raise _not_ported(what, "8")


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


def _grid_cells(p: int, m: int, d: int, device) -> torch.Tensor:
    """(p, d) int32 cell coordinates of each grid partition index."""
    i = torch.arange(p, dtype=torch.int32, device=device)
    return torch.stack([(i // (m ** k)) % m for k in range(d)], dim=1)


def _random_ids(generator, q: int, n: int, p: int, device) -> torch.Tensor:
    """(q, n) random-strategy ids: one draw per query, from that query's
    own generator when ``generator`` is a sequence of q of them, else q
    draws in turn from the one generator (seeded with 0 on the data's
    device when None)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    gens = (list(generator) if isinstance(generator, (list, tuple))
            else [generator] * q)
    if len(gens) != q:
        raise ValueError(f"got {len(gens)} generators for {q} queries")
    return torch.stack([partition.random_part_ids(g, n, p, device=device)
                        for g in gens])


def partition_stage(pts: torch.Tensor, mask: torch.Tensor, cfg: SkyConfig,
                    generator=None):
    """Partition-id map + routing into (p, C, d) buckets.

    Returns ``(buckets, meta, stats)`` as the reference does, with
    ``meta = {p, m, cells (p, d) int32, part_idx (p,) int32}``.  A
    (Q, N, d) batch is routed in the launches of one query: every
    strategy's ids, Grid Filtering and ``bucketize`` take the leading
    axis (one stable sort along N for all Q, a batched searchsorted, one
    scatter), every bucket and stat gains it, and ``meta`` is the same
    for every query.  Only the random strategy draws per query, so its
    device operations grow with Q (Q permutations): ``generator`` is one
    ``torch.Generator``, drawn from query after query, or a sequence of
    one per query (when None, one seeded with 0 on the data's
    device)."""
    check_supported(cfg)
    if pts.ndim == 2:
        if isinstance(generator, torch.Generator):
            generator = [generator]
        buckets, meta, stats = partition_stage(pts[None], mask[None], cfg,
                                               generator)
        return (partition.Buckets(*(x[0] for x in buckets)), meta,
                {k: v[0] for k, v in stats.items()})
    q, n, d = pts.shape
    dev = pts.device
    p, m = effective_parts(cfg, d)
    stats: dict[str, Any] = {}
    cells = torch.zeros((p, d), dtype=torch.int32, device=dev)
    if cfg.strategy == "random":
        ids = _random_ids(generator, q, n, p, dev)
    elif cfg.strategy == "sliced":
        ids = partition.sliced_part_ids(pts, mask, p, cfg.sliced_dim)
    elif cfg.strategy == "grid":
        if cfg.grid_filter:
            gf = filtering.grid_filter(pts, mask, m)
            mask = gf.mask
            stats["grid_filter_dropped"] = gf.dropped
        ids = partition.grid_part_ids(pts, m)
        cells = _grid_cells(p, m, d, dev)
    else:
        ids = partition.angular_part_ids(pts, m)
    cap = cfg.bucket_capacity or max(
        1, int(cfg.bucket_factor * _ceil_div(n, p)) + 1)
    buckets = partition.bucketize(pts, mask, ids, p, cap)
    meta = {"p": p, "m": m, "cells": cells,
            "part_idx": torch.arange(p, dtype=torch.int32, device=dev)}
    stats["bucket_counts"] = buckets.counts
    stats["bucket_overflow"] = buckets.overflow
    stats["n_valid"] = mask.sum(dim=-1).to(torch.int32)
    return buckets, meta, stats


def _drop_queries(result, stats, single: bool):
    """Drop the leading query axis that a single query was given."""
    if not single:
        return result, stats
    return (type(result)(*(x[0] for x in result)),
            {k: v[0] for k, v in stats.items()})


def _filter_by_local_reps(bufs, bmask, cfg: SkyConfig, generator):
    """Representative Filtering (paper §4.1) of a (Q, p, C, d) batch: the
    representatives of every partition in one selection (one dominance
    launch), each query's pool cleared of dominated representatives (one
    launch), and every partition against its query's pool (one launch).
    Returns the filtered mask and the dropped count per query."""
    q, p, cap, d = bufs.shape
    dom_impl = resolve_spec(cfg.impl, bufs.device).dominance
    if cfg.rep_filter == "random" and generator is None:
        generator = torch.Generator(device=bufs.device).manual_seed(0)
    flat, fmask = bufs.reshape(q * p, cap, d), bmask.reshape(q * p, cap)
    reps, rmask = filtering.select_representatives(
        flat, fmask, cfg.rep_k, strategy=cfg.rep_filter, generator=generator,
        impl=dom_impl)
    k = reps.shape[-2]
    pool, pmask = reps.reshape(q, p * k, d), rmask.reshape(q, p * k)
    # drop dominated representatives before sharing (paper §4.1)
    pmask = pmask & ~dominated_mask(pool, pool, pmask, impl=dom_impl)
    # the pool is shared by the partitions of its query (batch stride 0
    # when Q = 1)
    new = filtering.filter_by_representatives(
        flat, fmask,
        pool[:, None].expand(q, p, p * k, d).reshape(q * p, p * k, d),
        pmask[:, None].expand(q, p, p * k).reshape(q * p, p * k),
        impl=dom_impl).reshape(q, p, cap)
    dropped = bmask.sum(dim=(1, 2)) - new.sum(dim=(1, 2))
    return new, dropped.to(torch.int32)


def local_stage(bufs: torch.Tensor, bmask: torch.Tensor, cfg: SkyConfig, *,
                generator: torch.Generator | None = None):
    """Phase 1 on (p, C, d) buckets, or (Q, p, C, d) for Q queries: the
    optional representative filter, then the whole batch through ONE
    sweep launch."""
    check_supported(cfg)
    single = bufs.ndim == 3
    if single:
        bufs, bmask = bufs[None], bmask[None]
    q, p, cap, d = bufs.shape
    stats: dict[str, Any] = {}
    if cfg.rep_filter:
        bmask, stats["rep_filter_dropped"] = _filter_by_local_reps(
            bufs, bmask, cfg, generator)
    local_cap = cfg.local_capacity or cap
    sky = local_skyline_batch(bufs.reshape(q * p, cap, d),
                              bmask.reshape(q * p, cap), capacity=local_cap,
                              block=cfg.block, impl=cfg.impl,
                              wtile=cfg.wtile)
    sky = SkyBuffer(*(x.reshape((q, p) + x.shape[1:]) for x in sky))
    stats["local_sizes"] = sky.count
    stats["local_overflow"] = sky.overflow.any(dim=-1)
    return _drop_queries(sky, stats, single)


def compact_union(sky: SkyBuffer, cfg: SkyConfig) -> SkyBuffer:
    """The union of the local skylines, valid rows first, truncated to
    the capacity: the final pass scans |union| tuples, not p x capacity
    padded rows.  Leaves may carry a leading query axis."""
    flat = sky.points.flatten(-3, -2)
    return compact(flat, sky.mask.flatten(-2),
                   min(flat.shape[-2], max(cfg.capacity, 1)))


def _noseq_mask(sky: SkyBuffer, meta, cfg: SkyConfig, u: SkyBuffer):
    """NoSeq (paper §4.2) on (Q, p, C_loc, d) local skylines: every
    partition against its potential dominators among the compacted union
    ``u`` of its query, all Q x p in ONE dominance launch.  Each union
    row carries its partition's index and grid cell from ``meta``.
    Returns the (Q, p * C_loc) membership mask."""
    q, p, local_cap, d = sky.points.shape
    cap_u = u.points.shape[-2]
    dev = sky.points.device
    part_idx, cells = meta["part_idx"], meta["cells"]
    # each union row's source partition and cell, in the compacted order
    order = compact_order(sky.mask.reshape(q, -1), cap_u)
    ref_parts = part_idx.repeat_interleave(local_cap)[order]
    ref_cells = cells.repeat_interleave(local_cap, dim=0)[order]
    pd = noseq.pd_row_mask(cfg.strategy, part_idx, ref_parts[:, None, :],
                           cells, ref_cells[:, None])        # (Q, p, cap_u)
    keep = noseq.relative_skyline_mask(
        sky.points.reshape(q * p, local_cap, d),
        sky.mask.reshape(q * p, local_cap),
        u.points[:, None].expand(q, p, cap_u, d).reshape(q * p, cap_u, d),
        u.mask[:, None].expand(q, p, cap_u).reshape(q * p, cap_u),
        pd.reshape(q * p, cap_u),
        impl=resolve_spec(cfg.impl, dev).dominance)
    return keep.reshape(q, p * local_cap)


def merge_stage(sky: SkyBuffer, meta, cfg: SkyConfig):
    """Phase 2 on (p, C_loc, d) local skylines, or (Q, p, C_loc, d): the
    flat sequential merge (compact the union, sweep it: the second sweep
    launch) or NoSeq (one dominance launch, each partition's potential
    dominators from ``meta``'s indices and cells); then the canonical
    order.  ``merge='tree'`` runs the same flat math: there is no
    workers axis to reduce over."""
    check_supported(cfg)
    single = sky.points.ndim == 3
    if single:
        sky = SkyBuffer(*(x[None] for x in sky))
    u = compact_union(sky, cfg)
    union_size = sky.mask.sum(dim=(1, 2)).to(torch.int32)
    if not cfg.noseq:
        final = local_skyline_batch(u.points, u.mask, capacity=cfg.capacity,
                                    block=cfg.block, impl=cfg.impl,
                                    wtile=cfg.wtile)
        # block-SFS breaks score ties by input order; the total canonical
        # order makes the output independent of how the data reached it
        order = canonical_order(final.points, final.mask)
        final = SkyBuffer(gather_rows(final.points, order),
                          torch.gather(final.mask, -1, order), final.count,
                          final.overflow | u.overflow)
    else:
        all_pts = sky.points.flatten(1, 2)
        all_mask = _noseq_mask(sky, meta, cfg, u)
        # canonical order before compaction: the same order the
        # sequential merge emits
        order = canonical_order(all_pts, all_mask)
        final = compact(gather_rows(all_pts, order),
                        torch.gather(all_mask, -1, order), cfg.capacity)
        final = final._replace(overflow=final.overflow | u.overflow)
    return _drop_queries(final, {"union_size": union_size}, single)


def _local_merge(bufs, bmask, meta, *, cfg: SkyConfig, generator=None):
    """Phase 1 + phase 2 of one query, or of Q with a leading axis."""
    sky, s2 = local_stage(bufs, bmask, cfg, generator=generator)
    final, s3 = merge_stage(sky, meta, cfg)
    return final, dict(s2, **s3)


def fused_skyline_batch_fn(cfg: SkyConfig, mesh=None):
    """The batched pipeline, counterpart of the reference's
    ``fused_skyline_batch_fn(cfg)`` without a mesh: ``(pts (Q, N, d),
    mask (Q, N), generators) -> (SkyBuffer, stats)`` with a leading Q
    axis on every leaf.  ``generators`` is None or one
    ``torch.Generator`` per query (the random strategy's ids and
    representatives).  Q queries take the kernel launches of one: the
    partition stage routes all Q at once, and the local and merge stages
    flatten Q x p into the kernels' batch axes.  The random draws
    (``strategy='random'``, ``rep_filter='random'``) are made once per
    query, so their operations grow with Q.  A mesh raises (item 8 of
    ROADMAP.md)."""
    from repro_torch.core import incremental
    check_supported(cfg, mesh)

    def run(pts, mask, generators=None):
        state, stats = incremental._insert_batch(None, pts, mask, cfg=cfg,
                                                 generator=generators)
        return SkyBuffer(state.points, state.mask, state.count,
                         state.overflow), stats

    return run


def parallel_skyline(pts, mask=None, *, cfg: SkyConfig = SkyConfig(),
                     mesh=None, device=None,
                     generator: torch.Generator | None = None):
    """Compute SKY(pts) with the parallel pattern of the paper.

    ``pts`` is an (N, d) array or tensor and ``mask`` an optional (N,)
    validity mask; both are moved to ``device``, which is the card unless
    the caller passes ``device="cpu"`` (without CUDA that raises
    ``RuntimeError``).  ``generator`` draws the partition ids of
    ``strategy='random'`` and the representatives of
    ``rep_filter='random'``, in that order (when None, each draws from
    its own generator seeded with 0 on that device).  Returns
    ``(SkyBuffer, stats)``, every leaf a tensor on that device."""
    from repro_torch.core import incremental
    check_supported(cfg, mesh)
    pts, mask = as_inputs(pts, mask, device)
    if mask is None:
        mask = torch.ones((pts.shape[0],), dtype=torch.bool,
                          device=pts.device)
    state, stats = incremental._insert(None, pts, mask, cfg=cfg,
                                       generator=generator)
    return SkyBuffer(state.points, state.mask, state.count,
                     state.overflow), stats
