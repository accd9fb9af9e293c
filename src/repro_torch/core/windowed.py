"""Sliding-window skyline maintenance (`WindowedSkylineState`).

Counterpart of ``repro.core.windowed``.  The insert-only
``SkylineState`` cannot expire data: evicting a member can un-dominate
tuples it suppressed, so exact deletion needs retained candidates.  The
window keeps them **epoch-partitioned**: a ring of E epoch sub-states,
each a packed ``SkylineState``-style buffer holding the skyline of the
tuples that arrived in that epoch, including members that other epochs
dominate.  Eviction happens only within an epoch (same-epoch tuples
expire together, so a dominator outlives what it suppresses);
cross-epoch dominance is resolved at merge-on-read.

  ``WindowedSkylineState``  E ring slots of packed epoch antichains and
                    their stats, and two ring scalars: ``head`` (the
                    slot receiving arrivals) and ``active`` (the live
                    epoch count), 0-d int32 tensors on the state's
                    device.  Leaves may carry a leading Q axis (Q windows
                    on one ring clock).
  ``insert_chunk``  the ordinary incremental insert
                    (``repro_torch.core.incremental``) restricted to the
                    head epoch: 2 sweep + 2 dominance launches at the
                    default config, one or Q windows alike.
  ``advance_epoch`` opens the next slot as head; a full ring expires its
                    tail epoch by clearing that slot.
  ``expire_epoch``  drops the tail slot without opening an epoch.
  ``finalize``      merges the E epoch antichains on read through
                    ``parallel.merge_stage`` (each epoch a partition whose
                    local skyline is resolved): one sweep launch, or one
                    dominance launch under NoSeq, for one window or Q.
                    Bit for bit the one-shot skyline of exactly the
                    unexpired tuples.
  ``window_tick``   rotate (optionally), insert and merge-on-read in one
                    call.

The ring operations index slots with tensor operations, so they never
read the device from the host.  Every operation returns ``(state,
...)``: rebind the result.  Under ``SkyConfig.donate`` (inserts and the
tick) or the ``donate`` flag (advance and expiry), the reference's
buffer donation, both on by default, the operation writes the ring in
place (the head epoch with ``index_copy_``, the ring scalars with
``copy_``) and returns the state it was given; with donation off the
argument is left as it was.  Both give the same bits.

``insert_chunk`` and ``window_tick`` take a ``mesh``: the head epoch's
insert then runs on it (``incremental.insert_chunk``), with the whole
window replicated on every rank; the merge on read stays free of
collectives.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import incremental as inc
from repro_torch.core import parallel as par
from repro_torch.core.dominance import SENTINEL
from repro_torch.core.parallel import SkyConfig
from repro_torch.core.sfs import SkyBuffer
from repro_torch.kernels.backend import resolve_device

__all__ = ["WindowedSkylineState", "init_window_state", "window_epochs",
           "epoch_rows", "ring_advance", "ring_tail", "insert_chunk",
           "advance_epoch", "expire_epoch", "finalize", "window_tick",
           "window_counters"]


class WindowedSkylineState(NamedTuple):
    """Ring of E epoch sub-states.  Epoch leaves are ``(E, ...)`` or
    ``(Q, E, ...)``; expired and unopened slots are fully masked, so the
    flattened ring is exactly the retained-candidate set of the live
    window."""
    points: torch.Tensor    # (E, C, d) or (Q, E, C, d) packed epoch members
    mask: torch.Tensor      # (E, C) or (Q, E, C) bool validity
    count: torch.Tensor     # (E,) or (Q, E) int32, per-epoch antichain size
    overflow: torch.Tensor  # (E,) or (Q, E) bool, epoch capacity exceeded
    seen: torch.Tensor      # (E,) or (Q, E) int32, valid tuples fed
    chunks: torch.Tensor    # (E,) or (Q, E) int32, inserts absorbed
    head: torch.Tensor      # () int32, ring slot receiving arrivals
    active: torch.Tensor    # () int32, live epochs (1..E)


_EPOCH_LEAVES = ("points", "mask", "count", "overflow", "seen", "chunks")


def window_epochs(state: WindowedSkylineState) -> int:
    """Ring length E of a windowed state."""
    return state.points.shape[-3]


def _epoch_axis(state: WindowedSkylineState) -> int:
    """Position of the epoch axis (0 unbatched, 1 with a leading Q)."""
    return state.points.ndim - 3


def epoch_rows(cfg: SkyConfig, epoch_capacity: int = 0) -> int:
    """Row count of one epoch slot: ``epoch_capacity`` rounded up to the
    block, at most the state capacity, which is also the default.  An
    epoch front outgrowing its rows sets the overflow flag."""
    if not epoch_capacity:
        return inc.state_capacity(cfg)
    block = min(cfg.block, max(epoch_capacity, 1))
    return min(-(-max(epoch_capacity, 1) // block) * block,
               inc.state_capacity(cfg))


def init_window_state(cfg: SkyConfig, d: int, *, epochs: int,
                      dtype=torch.float32, q: int | None = None,
                      epoch_capacity: int = 0,
                      device=None) -> WindowedSkylineState:
    """Empty E-epoch window over ``d``-attribute tuples; ``q`` adds a
    leading axis (q windows on one ring clock).  Made on the card unless
    ``device="cpu"``; without CUDA that raises ``RuntimeError``."""
    if epochs < 1:
        raise ValueError(f"need at least one epoch, got {epochs}")
    dev = resolve_device(device)
    lead = () if q is None else (q,)
    c = epoch_rows(cfg, epoch_capacity)

    def zeros(dt):
        return torch.zeros(lead + (epochs,), dtype=dt, device=dev)

    return WindowedSkylineState(
        points=torch.full(lead + (epochs, c, d), SENTINEL, dtype=dtype,
                          device=dev),
        mask=torch.zeros(lead + (epochs, c), dtype=torch.bool, device=dev),
        count=zeros(torch.int32), overflow=zeros(torch.bool),
        seen=zeros(torch.int32), chunks=zeros(torch.int32),
        head=torch.zeros((), dtype=torch.int32, device=dev),
        active=torch.ones((), dtype=torch.int32, device=dev))


# -- ring-slot plumbing: the slot index is a tensor on the device ----------

def _sub_state(state: WindowedSkylineState, idx: torch.Tensor,
               axis: int) -> inc.SkylineState:
    """The ``SkylineState`` living in ring slot ``idx``."""
    at = idx.reshape(1).long()
    return inc.SkylineState(*(
        getattr(state, name).index_select(axis, at).squeeze(axis)
        for name in _EPOCH_LEAVES))


def _set_sub(state: WindowedSkylineState, sub: inc.SkylineState,
             idx: torch.Tensor, axis: int,
             donate: bool = False) -> WindowedSkylineState:
    """``state`` with ``sub`` in ring slot ``idx``: written in place
    under ``donate``, else a copy."""
    at = idx.reshape(1).long()
    if donate:
        for name in _EPOCH_LEAVES:
            getattr(state, name).index_copy_(
                axis, at, getattr(sub, name).unsqueeze(axis))
        return state
    return state._replace(**{
        name: getattr(state, name).index_copy(
            axis, at, getattr(sub, name).unsqueeze(axis))
        for name in _EPOCH_LEAVES})


def _set_clock(state: WindowedSkylineState, donate: bool,
               **scalars: torch.Tensor) -> WindowedSkylineState:
    """``state`` with new ring scalars (``head``, ``active``): copied
    into its own under ``donate``."""
    if donate:
        for name, value in scalars.items():
            getattr(state, name).copy_(value)
        return state
    return state._replace(**scalars)


def _blank_sub(state: WindowedSkylineState, axis: int) -> inc.SkylineState:
    """An empty sub-state shaped like one ring slot of ``state``."""
    def one(name):
        x = getattr(state, name)
        shape = x.shape[:axis] + x.shape[axis + 1:]
        if name == "points":
            return torch.full(shape, SENTINEL, dtype=x.dtype, device=x.device)
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    return inc.SkylineState(*(one(name) for name in _EPOCH_LEAVES))


def _clear_slot(state: WindowedSkylineState, idx: torch.Tensor,
                axis: int, donate: bool = False) -> WindowedSkylineState:
    return _set_sub(state, _blank_sub(state, axis), idx, axis, donate)


# -- the ring clock ---------------------------------------------------------

def ring_advance(head, active, epochs: int):
    """The ring clock after opening a new head epoch: ``(new_head,
    new_active, expired)``, ``expired`` iff the ring was full (the
    claimed slot held the tail epoch).  Takes host ints, numpy arrays
    (one clock per tenant) or tensors, and returns the same kind; a
    tensor clock is never read from the host."""
    if isinstance(active, torch.Tensor):
        new_active = (active + 1).clamp(max=epochs)
    elif isinstance(active, np.ndarray):
        new_active = np.minimum(active + 1, epochs)
    else:
        new_active = min(active + 1, epochs)
    return (head + 1) % epochs, new_active, active >= epochs


def ring_tail(head, active, epochs: int):
    """Ring slot holding the tail (oldest live) epoch."""
    return (head - active + 1) % epochs


def _expired_tuples(state: WindowedSkylineState, idx: torch.Tensor,
                    axis: int) -> torch.Tensor:
    cnt = state.count.index_select(axis, idx.reshape(1).long())
    return cnt.sum(dtype=torch.int32)


def advance_epoch(state: WindowedSkylineState, *, donate: bool = True):
    """Open the next ring slot as head.  With the ring full the claimed
    slot holds the tail epoch: clearing it is the expiry, and nothing is
    recomputed (the next merge-on-read resolves what it un-dominates).
    Returns ``(new_state, stats)``: rebind the state (``donate``: written
    in place)."""
    epochs, axis = window_epochs(state), _epoch_axis(state)
    new_head, new_active, expired = ring_advance(state.head, state.active,
                                                 epochs)
    stats = {"expired_epoch": expired,
             "expired_tuples": _expired_tuples(state, new_head, axis)}
    state = _clear_slot(state, new_head, axis, donate)
    return _set_clock(state, donate, head=new_head, active=new_active), stats


def expire_epoch(state: WindowedSkylineState, *, donate: bool = True):
    """Drop the tail epoch without opening a new one; expiring the only
    live epoch clears it, and the window stays open.  Returns
    ``(new_state, stats)``: rebind the state (``donate``: written in
    place)."""
    epochs, axis = window_epochs(state), _epoch_axis(state)
    tail = ring_tail(state.head, state.active, epochs)
    stats = {"expired_tuples": _expired_tuples(state, tail, axis)}
    state = _clear_slot(state, tail, axis, donate)
    return _set_clock(state, donate,
                      active=(state.active - 1).clamp(min=1)), stats


# -- insert: the incremental insert, restricted to the head epoch ----------

def insert_chunk(state: WindowedSkylineState, pts, mask=None, *,
                 cfg: SkyConfig, generator: torch.Generator | None = None,
                 mesh=None):
    """Route an arriving chunk, (N, d), or (Q, N, d) for Q windows, into
    the head epoch: pre-filter and evict run against the head epoch only
    (an older epoch's dominator may expire first).  Runs where the state
    lies.  Returns ``(new_state, stats)``: rebind the state (under
    ``cfg.donate`` it is ``state``, written in place).  ``generator``
    draws what ``incremental.insert_chunk`` draws; with a ``mesh`` the
    head epoch's insert runs on it as ``incremental.insert_chunk`` says
    (whole, replicated window on every rank)."""
    par.check_supported(cfg, mesh)
    batched = state.points.ndim == 4
    axis = 1 if batched else 0
    dev = state.points.device
    pts = torch.as_tensor(pts, device=dev).to(state.points.dtype)
    if pts.ndim != state.points.ndim - 1 or \
            pts.shape[-1] != state.points.shape[-1]:
        raise ValueError(f"chunk {tuple(pts.shape)} does not fit the window "
                         f"{tuple(state.points.shape)}")
    if mask is None:
        mask = torch.ones(pts.shape[:-1], dtype=torch.bool, device=dev)
    else:
        mask = torch.as_tensor(mask, device=dev).bool()
    # the head epoch is gathered into a copy, so its insert may write it
    # in place whatever the donation
    sub = _sub_state(state, state.head, axis)
    insert = inc._insert_batch if batched else inc._insert
    sub, stats = insert(sub, pts, mask, cfg=cfg, generator=generator,
                        donate=True, mesh=mesh)
    return _set_sub(state, sub, state.head, axis, cfg.donate), stats


# -- merge-on-read ----------------------------------------------------------

def _merge_cfg(cfg: SkyConfig) -> SkyConfig:
    """Epochs carry no inter-partition order (any two can
    cross-dominate), so the NoSeq potential dominators are the random
    strategy's: every other epoch.  The sequential merge never reads the
    strategy."""
    if cfg.noseq and cfg.strategy != "random":
        return dataclasses.replace(cfg, strategy="random")
    return cfg


def _merge_epochs(points: torch.Tensor, mask: torch.Tensor, *,
                  cfg: SkyConfig) -> SkyBuffer:
    """SKY(union of the epoch antichains) through ``merge_stage``, each
    epoch standing in for a partition whose local skyline is resolved.
    (E, C, d) or (Q, E, C, d); Q windows merge in the launches of one.
    With no workers axis ``merge='tree'`` is the flat math, as in the
    reference."""
    epochs, d = points.shape[-3], points.shape[-1]
    dev = points.device
    sky = SkyBuffer(points, mask, mask.sum(dim=-1, dtype=torch.int32),
                    torch.zeros(mask.shape[:-1], dtype=torch.bool,
                                device=dev))
    meta = {"p": epochs, "m": 0,
            "cells": torch.zeros((epochs, d), dtype=torch.int32, device=dev),
            "part_idx": torch.arange(epochs, dtype=torch.int32, device=dev)}
    final, _ = par.merge_stage(sky, meta, _merge_cfg(cfg))
    return final


def finalize(state: WindowedSkylineState, *, cfg: SkyConfig,
             mesh=None) -> SkyBuffer:
    """Canonical merge-on-read snapshot of one or Q live windows, fitted
    to the state capacity: bit for bit the one-shot skyline of exactly
    the unexpired tuples.  The state stays live.  The snapshot is free
    of collectives: under a ``mesh`` every rank holds the whole window
    and merges it on read, as the reference's batched snapshot runs
    device-local on each query shard."""
    par.check_supported(cfg, mesh)
    final = _merge_epochs(state.points, state.mask, cfg=cfg)
    pts, fmask = inc._fit_rows(final.points, final.mask,
                               inc.state_capacity(cfg))
    overflow = final.overflow | state.overflow.any(dim=-1)
    return SkyBuffer(pts, fmask, final.count, overflow)


def window_tick(state: WindowedSkylineState, pts, mask=None, *,
                cfg: SkyConfig, advance=False,
                generator: torch.Generator | None = None, mesh=None):
    """One serving tick: optionally rotate the ring, insert the arrivals
    into the head epoch and merge on read.  ``advance`` is a bool or a
    0-d bool tensor (then the claimed slot and the ring scalars are
    selected on the device, with no host read).  Donates as
    ``cfg.donate`` says; the insert runs on ``mesh`` when one is given.  Returns ``(new_state, front, stats)`` with the
    insert's stats; bit for bit the separate calls."""
    if isinstance(advance, torch.Tensor):
        epochs, axis = window_epochs(state), _epoch_axis(state)
        new_head, new_active, _ = ring_advance(state.head, state.active,
                                               epochs)
        # only the claimed slot and the clock change: blank the slot, or
        # write back what it holds
        kept = _sub_state(state, new_head, axis)
        slot = inc.SkylineState(*(
            torch.where(advance, b, k)
            for b, k in zip(_blank_sub(state, axis), kept)))
        state = _set_sub(state, slot, new_head, axis, cfg.donate)
        state = _set_clock(
            state, cfg.donate,
            head=torch.where(advance, new_head, state.head),
            active=torch.where(advance, new_active, state.active))
    elif advance:
        state, _ = advance_epoch(state, donate=cfg.donate)
    state, stats = insert_chunk(state, pts, mask, cfg=cfg,
                                generator=generator, mesh=mesh)
    return state, finalize(state, cfg=cfg), stats


def window_counters(state: WindowedSkylineState) -> dict[str, Any]:
    """Window-level running stats: sums over the live ring, as tensors
    on the state's device."""
    ax = _epoch_axis(state)
    return {"retained": state.count.sum(dim=ax, dtype=torch.int32),
            "seen": state.seen.sum(dim=ax, dtype=torch.int32),
            "chunks": state.chunks.sum(dim=ax, dtype=torch.int32),
            "overflow": state.overflow.any(dim=ax),
            "head": state.head.clone(), "active": state.active.clone()}
