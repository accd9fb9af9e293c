"""Shared slab allocator for thousands of tenant stream states.

Counterpart of ``repro.serve.slab``.  ONE device-resident arena per
*bucket key* (d, dtype, epochs, slot rows) holds all tenant states as
leased slots, so device buffers scale with the number of buckets, never
the number of streams, and a tenant's resident footprint is its slot's
row count (a small power of two that tracks its *front* size), not the
engine's full C-row state capacity.

  ``SlabArena``  the arena: one tensor per state leaf with a leading
                 slot axis ((S, E, R, d) points, (S, E, R) mask,
                 (S, E) int/bool stats) on the engine's device, a
                 host-side free list, and doubling growth.
  ``lease(k)``   claim k slots (grown and re-blanked as needed).
  ``release``    return slots to the free list (cleared lazily at the
                 next lease, in one batched write).

What the reference's buffer donation does becomes writes in place: the
engine's feed, promotion, tick and blanking write the leased slots of
the leaves with ``index_copy_`` / ``index_fill_``; growth copies the
leaves into tensors of twice the slots once.  The arenas belong to the
engine: every caller fetches ``leaves()`` anew and snapshots are
separate tensors, so no one can hold an old leaf, and the arena writes
in place whatever ``SkyConfig.donate`` says (the reference's
``SlabArena(donate=)`` has no counterpart).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dominance import SENTINEL

__all__ = ["SlabArena", "slot_rows_bucket", "blank_leaf", "blank_value",
           "index_tensor"]


def blank_value(dtype: torch.dtype):
    """The empty-slot value of a leaf of ``dtype``: the sentinel for
    point coordinates (the repo-wide invalid-row convention), zero for
    masks and stats."""
    return SENTINEL if dtype.is_floating_point else 0


def blank_leaf(shape, dtype: torch.dtype, device=None) -> torch.Tensor:
    """The empty-slot value of one state leaf: sentinel-filled for point
    coordinates, zeros for masks and stats.  The single definition
    shared by arena blanking and the engine's epoch clear."""
    return torch.full(shape, blank_value(dtype), dtype=dtype, device=device)


def index_tensor(values, device: torch.device) -> torch.Tensor:
    """A host list or array as an int64 tensor on ``device``.  On the
    card it goes through pinned memory with a ``non_blocking`` copy, so
    no host sync is made (the pinned block is kept until the copy
    ends)."""
    host = torch.from_numpy(np.asarray(values, dtype=np.int64).reshape(-1))
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def slot_rows_bucket(rows_needed: int, floor: int, cap: int) -> int:
    """Smallest power-of-two slot row count >= rows_needed, floored at
    ``floor`` and clipped to ``cap`` (the full state capacity: at the cap
    a slot holds the complete state and can never overflow)."""
    b = max(int(floor), 1)
    while b < rows_needed and b < cap:
        b *= 2
    return min(b, cap)


class SlabArena:
    """Device-resident slot arena for one bucket key.

    The six leaves mirror the windowed state's epoch leaves with a
    leading slot axis; slot contents are always a *packed* state (valid
    rows first), so an R-row slot faithfully round-trips any state whose
    per-epoch fronts fit in R rows."""

    def __init__(self, *, epochs: int, rows: int, d: int,
                 dtype=torch.float32, init_slots: int = 8, device=None):
        self.epochs = int(epochs)
        self.rows = int(rows)
        self.d = int(d)
        self.dtype = dtype
        self.device = torch.device("cpu" if device is None else device)
        s = max(int(init_slots), 1)
        self._leaves = self._alloc(s)
        self._free: list[int] = list(range(s))[::-1]
        self._free_set: set[int] = set(self._free)
        self._dirty: set[int] = set()
        self.leased = 0
        self.grows = 0

    # -- storage -----------------------------------------------------------

    def _alloc(self, slots: int):
        e, r, d, dev = self.epochs, self.rows, self.d, self.device
        return (
            blank_leaf((slots, e, r, d), self.dtype, dev),     # points
            blank_leaf((slots, e, r), torch.bool, dev),        # mask
            blank_leaf((slots, e), torch.int32, dev),          # count
            blank_leaf((slots, e), torch.bool, dev),           # overflow
            blank_leaf((slots, e), torch.int32, dev),          # seen
            blank_leaf((slots, e), torch.int32, dev),          # chunks
        )

    @property
    def capacity(self) -> int:
        return self._leaves[0].shape[0]

    @property
    def free(self) -> int:
        """Slots available without growing."""
        return self.capacity - self.leased

    def leaves(self):
        """The arena leaves (points, mask, count, overflow, seen,
        chunks); the engine's programs write leased slots in place."""
        return self._leaves

    def write(self, idx: torch.Tensor, values) -> None:
        """Write ``values`` (one per leaf, leading axis len(idx)) into
        the slots ``idx`` of every leaf, in place."""
        for a, v in zip(self._leaves, values, strict=True):
            a.index_copy_(0, idx, v)

    # -- accounting (the O(#buckets) assertion reads these) ----------------

    def num_buffers(self) -> int:
        """Device tensors held by this arena: constant per arena."""
        return len(self._leaves)

    def device_bytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self._leaves)

    # -- slot lifecycle ----------------------------------------------------

    def _grow(self, need: int) -> None:
        old = self.capacity
        new = old
        while new < old + need:
            new *= 2
        grown = self._alloc(new)
        for g, a in zip(grown, self._leaves):
            g[:old].copy_(a)
        self._leaves = grown
        self._free.extend(range(old, new)[::-1])
        self._free_set.update(range(old, new))
        self.grows += 1

    def lease(self, k: int) -> list[int]:
        """Claim k blank slots (grows the arena by doubling if the free
        list runs short; previously released slots are re-blanked in
        place in one batched write per leaf)."""
        if k < 1:
            raise ValueError(f"lease needs k >= 1, got {k}")
        if len(self._free) < k:
            self._grow(k - len(self._free))
        slots = [self._free.pop() for _ in range(k)]
        self._free_set.difference_update(slots)
        stale = [s for s in slots if s in self._dirty]
        if stale:
            idx = index_tensor(stale, self.device)
            for a in self._leaves:
                a.index_fill_(0, idx, blank_value(a.dtype))
            self._dirty.difference_update(stale)
        self.leased += k
        return slots

    def release(self, slots) -> None:
        """Return slots to the free list; contents are cleared lazily at
        the next lease that reuses them.  Double-releasing (or releasing
        a slot this arena never allocated) raises: a stale slot list
        would otherwise let two tenants lease the same slot."""
        slots = [int(s) for s in slots]
        bad = [s for s in slots
               if s in self._free_set or not 0 <= s < self.capacity]
        if bad:
            raise ValueError(f"slots {bad} are not currently leased "
                             f"from this arena")
        for s in slots:
            self._dirty.add(s)
            self._free.append(s)
        self._free_set.update(slots)
        self.leased -= len(slots)
