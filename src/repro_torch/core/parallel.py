"""Parallel skyline computation (paper Algorithm 2) on a device or a mesh.

Counterpart of ``repro.core.parallel``.  The three phases:

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

With a mesh (`repro_torch.launch.mesh.WorkerMesh`) the local and merge
stages run on this rank's share, as the reference's ``shard_map`` bodies
do (the SPMD mapping is set out in ``launch/mesh.py``): the partition
stage runs whole, each rank keeps its block of p/W partitions (and, on
a 2-D mesh, its shard of the queries), and the merge runs over the
workers group.  Two topologies, one answer outside overflow
(``resolve_merge``):

  flat  the union of the local skylines ``all_gather``-ed to every
        worker, then the one-device merge on it (NoSeq: each worker
        filters its own partitions and the masks are gathered);
  tree  ⌈log₂ W⌉ pruning ``ppermute`` rounds of capacity-sized buffers
        (`_tree_merge`): a worker-local sweep, then per round a
        two-sided dominance cross-filter (two dominance launches), or
        NoSeq's per-row filter (`noseq.relative_rows_mask`); the root's
        buffer is broadcast bit for bit.

``merge='tree'`` without a mesh, or with one worker, runs the flat
merge, as the reference does without a workers axis (the merge mode
changes the collective schedule, never the bits).
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
from repro_torch.core.dominance import apply_sentinel
from repro_torch.kernels.backend import resolve_spec
from repro_torch.launch.mesh import WorkerMesh

__all__ = ["SkyConfig", "parallel_skyline", "fused_skyline_batch_fn",
           "effective_parts", "merge_rounds", "resolve_merge",
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


def check_supported(cfg: SkyConfig, mesh=None) -> None:
    """Raise for a config or a mesh the pipeline cannot run: an unknown
    strategy or merge mode (``ValueError``), a mesh that is not a
    `repro_torch.launch.mesh.WorkerMesh` (``TypeError``)."""
    if cfg.strategy not in ("random", "grid", "angular", "sliced"):
        raise ValueError(f"unknown strategy {cfg.strategy!r}")
    if cfg.merge not in ("flat", "tree", "auto"):
        raise ValueError(f"unknown merge mode {cfg.merge!r} "
                         f"(expected flat | tree | auto)")
    if mesh is not None and not isinstance(mesh, WorkerMesh):
        raise TypeError(f"mesh must be a repro_torch.launch.mesh.WorkerMesh"
                        f", got {type(mesh).__name__}")


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's share of a batch on a mesh: queries ``[q0, q1)`` of
    ``qb`` and partitions ``[p0, p1)`` of ``p``."""
    mesh: WorkerMesh
    qb: int
    q0: int
    q1: int
    p: int
    p0: int
    p1: int

    @property
    def workers(self) -> int:
        return self.mesh.workers


def shard_of(mesh: WorkerMesh, qb: int, p: int, batched: bool) -> Shard:
    """This rank's share of ``qb`` queries of ``p`` partitions.  An
    unbatched call (one query) runs replicated over the queries axis, as
    the reference's 1-D program does on a 2-D mesh; a batch is cut into
    ``mesh.queries`` equal shards."""
    mesh.check_member()
    w, nq = mesh.workers, mesh.queries
    if p % w != 0:
        raise ValueError(f"p={p} not divisible by {w} workers")
    q0, q1 = 0, qb
    if batched and nq > 1:
        if qb % nq != 0:
            raise ValueError(f"Q={qb} not divisible by {nq} query shards")
        q0, q1 = mesh.q_index * qb // nq, (mesh.q_index + 1) * qb // nq
    p0, p1 = mesh.w_index * p // w, (mesh.w_index + 1) * p // w
    return Shard(mesh, qb, q0, q1, p, p0, p1)


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


def merge_rounds(axis_size: int) -> int:
    """⌈log₂(axis_size)⌉: the tree merge's ppermute round count."""
    return max(int(axis_size) - 1, 0).bit_length()


def resolve_merge(cfg: SkyConfig, *, axis_size=None, p_total=None,
                  local_cap=None, d=None) -> str:
    """The one merge-topology decision, shared by every path.

    ``'flat'`` / ``'tree'`` are honoured as they are; ``'auto'``
    compares the modelled per-worker boundary elements of the two
    schedules (the flat union moves p x C_loc rows to every worker, the
    tree O(capacity) rows per round over ⌈log₂ W⌉ rounds plus one
    broadcast) and picks the smaller.  Without a workers axis (None or
    1) 'auto' is 'flat'.  The reference's function."""
    if cfg.merge not in ("flat", "tree", "auto"):
        raise ValueError(f"unknown merge mode {cfg.merge!r} "
                         f"(expected flat | tree | auto)")
    if cfg.merge != "auto":
        return cfg.merge
    if not axis_size or axis_size < 2 or p_total is None:
        return "flat"
    cap = min(p_total * local_cap, max(cfg.capacity, 1))
    flat_elems = p_total * local_cap * d
    tree_elems = (merge_rounds(axis_size) + 2) * cap * (d + 1)
    return "tree" if flat_elems > tree_elems else "flat"


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


def _filter_by_local_reps(bufs, bmask, cfg: SkyConfig, generator,
                          shard: Shard | None = None):
    """Representative Filtering (paper §4.1) of a (Q, p, C, d) batch: the
    representatives of every partition in one selection (one dominance
    launch), each query's pool cleared of dominated representatives (one
    launch), and every partition against its query's pool (one launch).
    On a mesh the batch is this rank's share and the pool is gathered
    over the workers group; ``rep_filter='random'`` draws the whole
    batch's uniforms and keeps this share's.  Returns the filtered mask
    and the dropped count per query (of this rank's partitions)."""
    q, p, cap, d = bufs.shape
    dom_impl = resolve_spec(cfg.impl, bufs.device).dominance
    if cfg.rep_filter == "random" and generator is None:
        generator = torch.Generator(device=bufs.device).manual_seed(0)
    flat, fmask = bufs.reshape(q * p, cap, d), bmask.reshape(q * p, cap)
    draws = None
    if cfg.rep_filter == "random" and shard is not None:
        draws = filtering.uniform_draws((shard.qb * shard.p, cap), generator)
        draws = draws.reshape(shard.qb, shard.p, cap)[
            shard.q0:shard.q1, shard.p0:shard.p1].reshape(q * p, cap)
    reps, rmask = filtering.select_representatives(
        flat, fmask, cfg.rep_k, strategy=cfg.rep_filter, generator=generator,
        draws=draws, impl=dom_impl)
    k = reps.shape[-2]
    pool, pmask = reps.reshape(q, p * k, d), rmask.reshape(q, p * k)
    if shard is not None:
        pool = shard.mesh.all_gather(pool, dim=1)
        pmask = shard.mesh.all_gather(pmask, dim=1)
    pk = pool.shape[1]
    # drop dominated representatives before sharing (paper §4.1)
    pmask = pmask & ~dominated_mask(pool, pool, pmask, impl=dom_impl)
    # the pool is shared by the partitions of its query (batch stride 0
    # when Q = 1)
    new = filtering.filter_by_representatives(
        flat, fmask,
        pool[:, None].expand(q, p, pk, d).reshape(q * p, pk, d),
        pmask[:, None].expand(q, p, pk).reshape(q * p, pk),
        impl=dom_impl).reshape(q, p, cap)
    dropped = bmask.sum(dim=(1, 2)) - new.sum(dim=(1, 2))
    return new, dropped.to(torch.int32)


def local_stage(bufs: torch.Tensor, bmask: torch.Tensor, cfg: SkyConfig, *,
                generator: torch.Generator | None = None,
                shard: Shard | None = None):
    """Phase 1 on (p, C, d) buckets, or (Q, p, C, d) for Q queries: the
    optional representative filter, then the whole batch through ONE
    sweep launch.  On a mesh (``shard``) the buckets are this rank's
    partitions, ``local_sizes`` is gathered over the workers group, and
    ``local_overflow`` is worker 0's, as the reference's ``shard_map``
    returns it (its body's per-worker flag under a replicated
    out_spec)."""
    check_supported(cfg)
    single = bufs.ndim == 3
    if single:
        bufs, bmask = bufs[None], bmask[None]
    q, p, cap, d = bufs.shape
    stats: dict[str, Any] = {}
    if cfg.rep_filter:
        bmask, stats["rep_filter_dropped"] = _filter_by_local_reps(
            bufs, bmask, cfg, generator, shard)
    local_cap = cfg.local_capacity or cap
    sky = local_skyline_batch(bufs.reshape(q * p, cap, d),
                              bmask.reshape(q * p, cap), capacity=local_cap,
                              block=cfg.block, impl=cfg.impl,
                              wtile=cfg.wtile)
    sky = SkyBuffer(*(x.reshape((q, p) + x.shape[1:]) for x in sky))
    stats["local_sizes"] = sky.count
    stats["local_overflow"] = sky.overflow.any(dim=-1)
    if shard is not None:
        stats["local_sizes"] = shard.mesh.all_gather(sky.count, dim=1)
        stats["local_overflow"] = (stats["local_sizes"][:, :p]
                                   > local_cap).any(dim=-1)
    return _drop_queries(sky, stats, single)


def compact_union(sky: SkyBuffer, cfg: SkyConfig) -> SkyBuffer:
    """The union of the local skylines, valid rows first, truncated to
    the capacity: the final pass scans |union| tuples, not p x capacity
    padded rows.  Leaves may carry a leading query axis."""
    flat = sky.points.flatten(-3, -2)
    return compact(flat, sky.mask.flatten(-2),
                   min(flat.shape[-2], max(cfg.capacity, 1)))


def _noseq_mask(points, mask, own_idx, own_cells, union_mask, meta,
                cfg: SkyConfig, u: SkyBuffer):
    """NoSeq (paper §4.2) on (Q, p, C_loc, d) local skylines: every
    partition against its potential dominators among the compacted union
    ``u`` of its query, all Q x p in ONE dominance launch.  The
    partitions are ``own_idx`` with cells ``own_cells`` (this rank's, on
    a mesh); each union row carries its partition's index and grid cell
    from ``meta``, in the order ``union_mask`` (Q, p_total, C_loc)
    compacts to.  Returns the (Q, p * C_loc) membership mask."""
    q, p, local_cap, d = points.shape
    cap_u = u.points.shape[-2]
    order = compact_order(union_mask.reshape(q, -1), cap_u)
    ref_parts = meta["part_idx"].repeat_interleave(local_cap)[order]
    ref_cells = meta["cells"].repeat_interleave(local_cap, dim=0)[order]
    pd = noseq.pd_row_mask(cfg.strategy, own_idx, ref_parts[:, None, :],
                           own_cells, ref_cells[:, None])    # (Q, p, cap_u)
    keep = noseq.relative_skyline_mask(
        points.reshape(q * p, local_cap, d), mask.reshape(q * p, local_cap),
        u.points[:, None].expand(q, p, cap_u, d).reshape(q * p, cap_u, d),
        u.mask[:, None].expand(q, p, cap_u).reshape(q * p, cap_u),
        pd.reshape(q * p, cap_u),
        impl=resolve_spec(cfg.impl, points.device).dominance)
    return keep.reshape(q, p * local_cap)


def _pack_wire(pts, msk, parts=None, cells=None) -> torch.Tensor:
    """ONE tensor per exchange: the points, the mask as a 1.0/0.0
    column and (NoSeq) each row's partition index and grid cell as exact
    small-integer float columns."""
    cols = [pts, msk.to(pts.dtype)[..., None]]
    if parts is not None:
        cols += [parts.to(pts.dtype)[..., None], cells.to(pts.dtype)]
    return torch.cat(cols, dim=-1)


def _take(order, *rows):
    """Each (Q, R, ...) tensor of ``rows`` at ``order`` (Q, K) along R."""
    out = []
    for x in rows:
        out.append(gather_rows(x, order) if x.ndim == 3
                   else torch.gather(x, -1, order))
    return out


def _tree_merge(sky: SkyBuffer, cfg: SkyConfig, *, part_idx, cells,
                shard: Shard):
    """The hierarchical merge: ⌈log₂ W⌉ pruning ppermute rounds
    (``repro.core.parallel._tree_merge``), for Q queries at once.

    Round r (stride s = 2^r) sends worker i+s's buffer to worker i for
    every receiver i ≡ 0 (mod 2s): a reduce to the root that is exact for
    any W.  Workers outside the round's partial permutation receive zeros
    (an all-masked buffer).  Sequential: a worker-local sweep (one sweep
    launch), then per round a two-sided cross-filter (two dominance
    launches; both sides are antichains, so the survivors are the
    union's skyline).  NoSeq: each row keeps its partition and cell, and
    `noseq.relative_rows_mask` filters per row pair.  Worker 0's buffer
    is then broadcast bit for bit and put in the canonical order.  Every
    exchanged tensor is O(capacity) rows, and the answer is the flat
    merge's bit for bit outside overflow.  Returns ``(final,
    union_size)``."""
    mesh, w = shard.mesh, shard.workers
    q, p_loc, local_cap, d = sky.points.shape
    union_size = mesh.psum(sky.mask.sum(dim=(1, 2), dtype=torch.int32))
    flat = sky.points.reshape(q, -1, d)
    fmask = sky.mask.reshape(q, -1)
    cap_u = min(w * flat.shape[1], max(cfg.capacity, 1))
    overflow = union_size > cap_u
    rounds = [(1 << r, [(i + (1 << r), i)
                        for i in range(0, w - (1 << r), 2 << r)])
              for r in range(merge_rounds(w))]

    if not cfg.noseq:
        # worker-local reduce: the flat merge's math on this worker's
        # shard (at W = 1 this is the flat merge, bit for bit)
        own = compact(flat, fmask, min(flat.shape[1], max(cfg.capacity, 1)))
        buf = local_skyline_batch(own.points, own.mask,
                                  capacity=cfg.capacity, block=cfg.block,
                                  impl=cfg.impl, wtile=cfg.wtile)
        pts, msk = buf.points, buf.mask
        dom_impl = resolve_spec(cfg.impl, pts.device).dominance
        rows = pts.shape[1]
        for _, perm in rounds:
            rcv = mesh.ppermute(_pack_wire(pts, msk), perm)
            rpts, rmsk = rcv[..., :d], rcv[..., d] > 0.5
            keep_own = filtering.filter_by_representatives(
                pts, msk, rpts, rmsk, impl=dom_impl)
            keep_rcv = filtering.filter_by_representatives(
                rpts, rmsk, pts, msk, impl=dom_impl)
            # survivors fit `rows` unless the union overflowed (flagged)
            out = compact(torch.cat([pts, rpts], 1),
                          torch.cat([keep_own, keep_rcv], 1), rows)
            pts, msk = out.points, out.mask
        wire = mesh.broadcast_from_root(_pack_wire(pts, msk))
        msk = wire[..., d] > 0.5
        pts = apply_sentinel(wire[..., :d], msk)
        order = canonical_order(pts, msk)
        pts, msk = _take(order, pts, msk)
        return SkyBuffer(pts, msk, msk.sum(dim=-1, dtype=torch.int32),
                         overflow), union_size

    # NoSeq: rows keep their origin partition (and grid cell)
    parts = part_idx.repeat_interleave(local_cap).expand(q, -1)
    pcells = cells.repeat_interleave(local_cap, dim=0).expand(q, -1, -1)
    take = min(flat.shape[1], cap_u)
    pts, msk, pparts, pcells = _take(compact_order(fmask, take), flat, fmask,
                                     parts, pcells)
    if take < cap_u:
        # pad to the union's budget, so that in-round survivors never
        # truncate before the union itself overflows
        def pad(x):
            return torch.cat([x, x.new_zeros((q, cap_u - take)
                                             + x.shape[2:])], 1)
        pts, msk, pparts, pcells = map(pad, (pts, msk, pparts, pcells))
    # self-filter within the worker (the same-shard pairs the flat merge
    # tests through the whole gathered union)
    msk = noseq.relative_rows_mask(pts, msk, pparts, pcells,
                                   strategy=cfg.strategy, block=cfg.block)
    for _, perm in rounds:
        rcv = mesh.ppermute(_pack_wire(pts, msk, pparts, pcells), perm)
        cpts = torch.cat([pts, rcv[..., :d]], 1)
        cmsk = torch.cat([msk, rcv[..., d] > 0.5], 1)
        cparts = torch.cat([pparts, rcv[..., d + 1].to(torch.int32)], 1)
        ccells = torch.cat([pcells, rcv[..., d + 2:].to(torch.int32)], 1)
        cmsk = noseq.relative_rows_mask(cpts, cmsk, cparts, ccells,
                                        strategy=cfg.strategy,
                                        block=cfg.block)
        pts, msk, pparts, pcells = _take(compact_order(cmsk, cap_u), cpts,
                                         cmsk, cparts, ccells)
    wire = mesh.broadcast_from_root(_pack_wire(pts, msk, pparts, pcells))
    pts, msk = wire[..., :d], wire[..., d] > 0.5
    order = canonical_order(pts, msk)
    pts, msk = _take(order, pts, msk)
    final = compact(pts, msk, cfg.capacity)
    return final._replace(overflow=final.overflow | overflow), union_size


def merge_stage(sky: SkyBuffer, meta, cfg: SkyConfig, *,
                shard: Shard | None = None):
    """Phase 2 on (p, C_loc, d) local skylines, or (Q, p, C_loc, d): the
    flat sequential merge (compact the union, sweep it: the second sweep
    launch) or NoSeq (one dominance launch, each partition's potential
    dominators from ``meta``'s indices and cells); then the canonical
    order.  On a mesh (``shard``) the local skylines are this rank's
    partitions: the tree merge runs `_tree_merge`; the flat merge
    gathers the union over the workers group (NoSeq: each worker filters
    its own partitions and the masks are gathered).  ``merge='tree'``
    without a mesh runs the flat math: there is no workers axis to
    reduce over."""
    check_supported(cfg)
    single = sky.points.ndim == 3
    if single:
        sky = SkyBuffer(*(x[None] for x in sky))
    q, p_loc, local_cap, d = sky.points.shape
    w = None if shard is None else shard.workers
    mode = resolve_merge(cfg, axis_size=w, p_total=p_loc * (w or 1),
                         local_cap=local_cap, d=d)
    if mode == "tree" and shard is not None:
        final, union_size = _tree_merge(
            sky, cfg, part_idx=meta["part_idx"][shard.p0:shard.p1],
            cells=meta["cells"][shard.p0:shard.p1], shard=shard)
        return _drop_queries(final, {"union_size": union_size}, single)
    if shard is None:
        u_pts, u_mask = sky.points, sky.mask
    else:
        u_pts = shard.mesh.all_gather(sky.points, dim=1)
        u_mask = shard.mesh.all_gather(sky.mask, dim=1)
    u = compact_union(SkyBuffer(u_pts, u_mask, None, None), cfg)
    union_size = u_mask.sum(dim=(1, 2)).to(torch.int32)
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
        lo, hi = (0, p_loc) if shard is None else (shard.p0, shard.p1)
        keep = _noseq_mask(sky.points, sky.mask, meta["part_idx"][lo:hi],
                           meta["cells"][lo:hi], u_mask, meta, cfg, u)
        if shard is not None:
            keep = shard.mesh.all_gather(keep, dim=1)
        all_pts = u_pts.flatten(1, 2)
        # canonical order before compaction: the same order the
        # sequential merge emits
        order = canonical_order(all_pts, keep)
        final = compact(gather_rows(all_pts, order),
                        torch.gather(keep, -1, order), cfg.capacity)
        final = final._replace(overflow=final.overflow | u.overflow)
    return _drop_queries(final, {"union_size": union_size}, single)


def _local_merge(bufs, bmask, meta, *, cfg: SkyConfig, generator=None,
                 shard: Shard | None = None):
    """Phase 1 + phase 2 of one query, or of Q with a leading axis, on
    this rank's share when ``shard`` is given."""
    sky, s2 = local_stage(bufs, bmask, cfg, generator=generator, shard=shard)
    final, s3 = merge_stage(sky, meta, cfg, shard=shard)
    return final, dict(s2, **s3)


def fused_skyline_batch_fn(cfg: SkyConfig, mesh: WorkerMesh | None = None):
    """The batched pipeline, counterpart of the reference's
    ``fused_skyline_batch_fn(cfg, mesh)``: ``(pts (Q, N, d), mask (Q,
    N), generators) -> (SkyBuffer, stats)`` with a leading Q axis on
    every leaf.  ``generators`` is None or one ``torch.Generator`` per
    query (the random strategy's ids and representatives).  Q queries
    take the kernel launches of one: the partition stage routes all Q at
    once, and the local and merge stages flatten Q x p into the kernels'
    batch axes.  The random draws (``strategy='random'``,
    ``rep_filter='random'``) are made once per query, so their
    operations grow with Q.  With a 2-D (queries x workers) mesh, Q must
    be a multiple of the queries size and p of the workers size; each
    rank computes its query shard over its workers group, and the whole
    batch comes back on every rank."""
    from repro_torch.core import incremental
    check_supported(cfg, mesh)

    def run(pts, mask, generators=None):
        state, stats = incremental._insert_batch(None, pts, mask, cfg=cfg,
                                                 generator=generators,
                                                 mesh=mesh)
        return SkyBuffer(state.points, state.mask, state.count,
                         state.overflow), stats

    return run


def parallel_skyline(pts, mask=None, *, cfg: SkyConfig = SkyConfig(),
                     mesh: WorkerMesh | None = None, device=None,
                     generator: torch.Generator | None = None):
    """Compute SKY(pts) with the parallel pattern of the paper.

    ``pts`` is an (N, d) array or tensor and ``mask`` an optional (N,)
    validity mask; both are moved to ``device``, which is the card unless
    the caller passes ``device="cpu"`` (without CUDA that raises
    ``RuntimeError``), or the mesh's device when a ``mesh`` is given.
    With a mesh, partitions are split over its workers (p must be a
    multiple of their count) and every rank of the mesh gets the whole
    answer.  ``generator`` draws the partition ids of
    ``strategy='random'`` and the representatives of
    ``rep_filter='random'``, in that order (when None, each draws from
    its own generator seeded with 0 on that device).  Returns
    ``(SkyBuffer, stats)``, every leaf a tensor on that device."""
    from repro_torch.core import incremental
    check_supported(cfg, mesh)
    pts, mask = as_inputs(pts, mask, mesh.device if mesh is not None
                          and device is None else device)
    if mask is None:
        mask = torch.ones((pts.shape[0],), dtype=torch.bool,
                          device=pts.device)
    state, stats = incremental._insert(None, pts, mask, cfg=cfg,
                                       generator=generator, mesh=mesh)
    return SkyBuffer(state.points, state.mask, state.count,
                     state.overflow), stats
