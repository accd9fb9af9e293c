"""Incremental skyline maintenance (`SkylineState`).

Counterpart of ``repro.core.incremental``.  The retained buffer of the paper's sequential filtering IS a running
skyline, so an arriving chunk only has to be (a) filtered against it,
(b) reduced to its own skyline, and (c) merged back, evicting the
members the new tuples dominate:

  ``init_state``    an empty state (all-masked buffer, zeroed counters),
                    optionally with a leading Q axis for Q live skylines;
                    made on the card unless ``device="cpu"``.
  ``insert_chunk``  the pre-filter against the live skyline (one
                    dominance launch), the chunk's skyline by partition ->
                    local -> merge (two sweep launches at the default
                    config), the eviction (one dominance launch) and one
                    compaction pass.  Q states take the same launches as
                    one: Q x p partitions go to the sweep as one batch and
                    Q to the dominance kernel's batch axis.
  ``finalize``      the state in canonical order, bit for bit the
                    one-shot ``parallel_skyline`` answer for the same
                    data, however it was chunked.

One-shot ``parallel_skyline`` is "insert everything into an empty
state": the fresh insert skips the pre-filter and the eviction, so its
body is exactly partition -> local -> merge.

On a mesh (`repro_torch.launch.mesh`) the chunk's skyline is computed
by the ranks together (``_chunk_skyline``), and the state stays whole
and replicated: every rank runs the pre-filter, the eviction and the
compaction on it, and holds the same new state.

Exactness (by transitivity): a chunk tuple dominated by a live member
can only lose that dominator to a new tuple that dominates it too, so
the pre-filter is safe; any chunk tuple that dominates a live member is
a surviving new member or dominated by one (never by a live member: the
buffer is an antichain), so testing the buffer against the chunk's
survivors alone evicts completely.

``SkyConfig.donate`` is the reference's buffer donation.  With it on
(the default) an insert writes the state in place and returns it: the
compaction gathers straight into the state's points and mask, the
counters are updated in place, and the returned leaves are the input's
own tensors, so the old binding reads the new values.  With
``donate=False`` the input state is left as it was and a new one comes
back.  Both give the same bits.  Snapshots never alias a state leaf.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import parallel as par
from repro_torch.core.dominance import (SENTINEL, apply_sentinel,
                                        canonical_order, dominated_mask)
from repro_torch.core.parallel import SkyConfig
from repro_torch.core.sfs import SkyBuffer, compact, gather_rows
from repro_torch.kernels.backend import resolve_device, resolve_spec

__all__ = ["SkylineState", "state_capacity", "init_state", "insert_chunk",
           "finalize"]


class SkylineState(NamedTuple):
    """Fixed-capacity running skyline.  Leaves are unbatched (one live
    skyline) or carry a leading Q axis.  The buffer is an antichain
    holding the skyline of every valid tuple fed so far (unless
    ``overflow`` reports that capacity was exceeded)."""
    points: torch.Tensor    # (C, d) or (Q, C, d) packed members
    mask: torch.Tensor      # (C,) or (Q, C) bool validity
    count: torch.Tensor     # () or (Q,) int32, live skyline size
    overflow: torch.Tensor  # () or (Q,) bool, capacity ever exceeded
    seen: torch.Tensor      # () or (Q,) int32, valid tuples fed so far
    chunks: torch.Tensor    # () or (Q,) int32, inserts absorbed


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def state_capacity(cfg: SkyConfig) -> int:
    """Row count of the state buffer: the final-merge window size
    (capacity rounded up to the block), so the one-shot answer drops
    into a state with no reshaping."""
    return _ceil_to(max(cfg.capacity, 1), cfg.block)


def init_state(cfg: SkyConfig, d: int, *, dtype=torch.float32,
               q: int | None = None, device=None) -> SkylineState:
    """Empty state for ``d``-attribute tuples; ``q`` adds a leading axis
    (q live skylines).  Made on the card unless ``device="cpu"``; without
    CUDA that raises ``RuntimeError``."""
    dev = resolve_device(device)
    lead = () if q is None else (q,)
    c = state_capacity(cfg)

    def zeros(dt):
        return torch.zeros(lead, dtype=dt, device=dev)

    return SkylineState(
        points=torch.full(lead + (c, d), SENTINEL, dtype=dtype, device=dev),
        mask=torch.zeros(lead + (c,), dtype=torch.bool, device=dev),
        count=zeros(torch.int32), overflow=zeros(torch.bool),
        seen=zeros(torch.int32), chunks=zeros(torch.int32))


def _fit_rows(points: torch.Tensor, mask: torch.Tensor, rows: int):
    """Pad (sentinel/False) or truncate the row axis to ``rows``.

    The merge window is capacity rounded to the *effective* block (the
    block is clipped to the union size for tiny unions), so its row
    count can differ from ``state_capacity``; truncation is safe because
    members never exceed the compacted union, which is below the state
    capacity whenever the shapes differ."""
    c = points.shape[-2]
    if c >= rows:
        return points[..., :rows, :], mask[..., :rows]
    pad_p = torch.full(points.shape[:-2] + (rows - c, points.shape[-1]),
                       SENTINEL, dtype=points.dtype, device=points.device)
    pad_m = torch.zeros(mask.shape[:-1] + (rows - c,), dtype=torch.bool,
                        device=mask.device)
    return torch.cat([points, pad_p], -2), torch.cat([mask, pad_m], -1)


def _chunk_skyline(pts, mask, *, cfg: SkyConfig, generator=None, mesh=None,
                   batched: bool = True):
    """SKY of each chunk of a (Q, N, d) batch via partition -> local ->
    merge.  On a mesh the partition stage runs whole, this rank's share
    (its block of partitions, and of a ``batched`` call its query shard)
    goes through local -> merge over the workers group, and the query
    shards are assembled into the whole batch."""
    buckets, meta, stats = par.partition_stage(pts, mask, cfg, generator)
    if mesh is None:
        final, s2 = par._local_merge(buckets.points, buckets.mask, meta,
                                     cfg=cfg, generator=generator)
    else:
        sh = par.shard_of(mesh, pts.shape[0], meta["p"], batched)
        final, s2 = par._local_merge(
            buckets.points[sh.q0:sh.q1, sh.p0:sh.p1],
            buckets.mask[sh.q0:sh.q1, sh.p0:sh.p1], meta, cfg=cfg,
            generator=generator, shard=sh)
        if sh.q1 - sh.q0 < sh.qb:
            final = SkyBuffer(*map(mesh.assemble_queries, final))
            s2 = {k: mesh.assemble_queries(v) for k, v in s2.items()}
    stats.update(s2)
    overflow = buckets.overflow | stats["local_overflow"] | final.overflow
    return final._replace(overflow=overflow), stats


def _insert_batch(state: SkylineState | None, pts, mask, *, cfg: SkyConfig,
                  generator=None, donate: bool = False, mesh=None,
                  batched: bool = True):
    """Q live skylines advanced together: (Q, N, d) chunks into a state
    with a leading Q axis.  ``state=None`` is the fresh-state path,
    exactly the one-shot pipeline.  ``donate`` writes the result into
    ``state``'s own tensors and returns ``state``.  On a mesh the
    chunks' skylines are computed as `_chunk_skyline` says (``batched``
    False: one query, replicated over the queries axis); the state is
    whole and replicated on every rank, and so is the result."""
    c = state_capacity(cfg) if state is None else state.points.shape[-2]
    dom_impl = resolve_spec(cfg.impl, pts.device).dominance
    stats: dict[str, Any] = {}
    if state is not None:
        stats["chunk_arrivals"] = mask.sum(dim=-1).to(torch.int32)
        # pre-filter the arriving chunks against the live skylines
        mask = mask & ~dominated_mask(pts, state.points, state.mask,
                                      impl=dom_impl)
    sky, pstats = _chunk_skyline(pts, mask, cfg=cfg, generator=generator,
                                 mesh=mesh, batched=batched)
    stats.update(pstats)
    new_pts, new_mask = _fit_rows(sky.points, sky.mask, c)

    if state is None:
        nst = SkylineState(new_pts, new_mask, sky.count, sky.overflow,
                           seen=stats["n_valid"],
                           chunks=torch.ones_like(sky.count))
        return nst, stats

    # evict live members newly dominated by the chunks' survivors, then
    # merge both antichains with one stable compaction pass
    evict = state.mask & dominated_mask(state.points, new_pts, new_mask,
                                        impl=dom_impl)
    # the concatenation is a copy, so the compaction may gather straight
    # into a donated state's points and mask
    merged = compact(torch.cat([state.points, new_pts], dim=-2),
                     torch.cat([state.mask & ~evict, new_mask], dim=-1), c,
                     out=(state.points, state.mask) if donate else None)
    overflow = (state.overflow | sky.overflow | merged.overflow
                | (merged.count > cfg.capacity) | (sky.count > c))
    if donate:
        state.count.copy_(merged.count)
        state.overflow.copy_(overflow)
        state.seen.add_(stats["chunk_arrivals"])
        state.chunks.add_(1)
        nst = state
    else:
        nst = SkylineState(merged.points, merged.mask, merged.count,
                           overflow, seen=state.seen + stats["chunk_arrivals"],
                           chunks=state.chunks + 1)
    stats["evicted"] = evict.sum(dim=-1).to(torch.int32)
    stats["inserted"] = sky.count
    return nst, stats


def _insert(state: SkylineState | None, pts, mask, *, cfg: SkyConfig,
            generator=None, donate: bool = False, mesh=None):
    """One live skyline's insert: the batched insert with Q = 1 (under
    ``donate`` through views of ``state``, which comes back itself)."""
    batch = None if state is None else SkylineState(*(x[None] for x in state))
    nst, stats = _insert_batch(batch, pts[None], mask[None], cfg=cfg,
                               generator=generator, donate=donate,
                               mesh=mesh, batched=False)
    stats = {k: v[0] for k, v in stats.items()}
    if donate:
        return state, stats
    return SkylineState(*(x[0] for x in nst)), stats


def insert_chunk(state: SkylineState, pts, mask=None, *, cfg: SkyConfig,
                 generator: torch.Generator | None = None, mesh=None):
    """Insert a chunk into one live skyline, (N, d) points, or into Q of
    them when the state has a leading Q axis, (Q, N, d) points.

    Runs where the state lies; the chunk is moved there.  Returns
    ``(new_state, stats)``: rebind the state.  Under ``cfg.donate`` (the
    default) ``new_state`` is ``state``, written in place; with
    ``donate=False`` ``state`` is left as it was.  ``generator`` draws the
    partition ids of ``strategy='random'`` and the representatives of
    ``rep_filter='random'`` (when None, each draws from its own
    generator seeded with 0).  With a ``mesh`` (a 1-D workers mesh, or
    for Q states a 2-D one whose queries size divides Q) every rank
    passes the same whole state and chunk and gets the same new state;
    the chunk's partitions are split over the workers (p must be a
    multiple of their count)."""
    par.check_supported(cfg, mesh)
    dev = state.points.device
    pts = torch.as_tensor(pts, device=dev).to(state.points.dtype)
    if pts.ndim != state.points.ndim or pts.shape[-1] != state.points.shape[-1]:
        raise ValueError(f"chunk {tuple(pts.shape)} does not fit the state "
                         f"{tuple(state.points.shape)}")
    if mask is None:
        mask = torch.ones(pts.shape[:-1], dtype=torch.bool, device=dev)
    else:
        mask = torch.as_tensor(mask, device=dev).bool()
    insert = _insert_batch if state.points.ndim == 3 else _insert
    return insert(state, pts, mask, cfg=cfg, generator=generator,
                  donate=cfg.donate, mesh=mesh)


def finalize(state: SkylineState, *, cfg: SkyConfig) -> SkyBuffer:
    """Canonical ``SkyBuffer`` snapshot of one or Q live skylines: the
    total order of ``canonical_order`` and sentinel fill.  The state is an
    antichain, so no dominance test is needed, and the total order makes
    the snapshot bit for bit the one-shot answer for the same data.  The
    state stays live, and no leaf of the snapshot aliases it (a donated
    insert would write it)."""
    del cfg  # the snapshot depends on the state alone
    order = canonical_order(state.points, state.mask)
    mask = torch.gather(state.mask, -1, order)
    return SkyBuffer(apply_sentinel(gather_rows(state.points, order), mask),
                     mask, state.count.clone(), state.overflow.clone())
