"""Pareto-front request admission for the serving path.

Counterpart of ``repro.serve.scheduler``.  Requests carry (deadline
slack, -priority, estimated cost); the admission batch is built
skyline-first: no admitted request is dominated on all three criteria by
a rejected one.

Fronts come from the batched `SkylineEngine` (`repro_torch.serve.engine`),
so many queues (one per tenant or priority class) take one dominance
launch per size bucket (`admit_many`).  `admit` keeps the one-queue
signature and shares a default module-level engine.

`StreamingAdmitter` maintains the admission fronts on the device as
requests arrive (`SkylineEngine.open_stream`), each batch of arrivals
one feed wave for all queues; `WindowedAdmitter` lets requests age out
of a sliding window.

The criteria are normalised in f32 with subnormals flushed, and the
urgency score adds them left to right from +0.0, as the reference's XLA
arithmetic does; the ranking is a stable sort that ranks signed zeros
equal (`core.dominance.stable_argsort`), so the admitted indices are the
reference's.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.dominance import (flush_subnormal, monotone_score,
                                        stable_argsort)
from repro_torch.core.parallel import SkyConfig
from repro_torch.launch.mesh import (engine_mesh_shape, make_engine_mesh,
                                     world_size)
from repro_torch.serve.engine import SkylineEngine, StreamOptions

__all__ = ["Request", "admit", "admit_many", "StreamingAdmitter",
           "WindowedAdmitter", "default_engine", "make_default_engine"]


class Request(NamedTuple):
    slack: Any              # seconds to deadline (smaller = more urgent)
    neg_priority: Any
    cost: Any               # estimated decode tokens


_DEFAULT_ENGINE: SkylineEngine | None = None


def make_default_engine(cfg: SkyConfig = SkyConfig(),
                        **engine_kwargs) -> SkylineEngine:
    """The engine of this rank (on the card unless ``device="cpu"`` is
    passed).  In a world of more than one rank it gets a 2-D (queries x
    workers) mesh over the whole world, factored so that the workers
    size divides cfg's partition count, and large batches shard over
    it; in a world of one it is the one-device engine."""
    if "mesh" not in engine_kwargs and world_size() > 1:
        queries, workers = engine_mesh_shape(cfg.p)
        engine_kwargs["mesh"] = make_engine_mesh(
            queries, workers, device=engine_kwargs.get("device"))
    return SkylineEngine(cfg, **engine_kwargs)


def default_engine() -> SkylineEngine:
    global _DEFAULT_ENGINE
    if _DEFAULT_ENGINE is None:
        _DEFAULT_ENGINE = make_default_engine()
    return _DEFAULT_ENGINE


def _raw_criteria(reqs: Request, device=None) -> torch.Tensor:
    """(n, 3) f32 criteria rows (slack, -priority, cost), stacked where
    the columns lie and moved to ``device`` in one copy."""
    cols = [torch.as_tensor(x).to(torch.float32)
            for x in (reqs.slack, reqs.neg_priority, reqs.cost)]
    return torch.stack(cols, dim=-1).to(device)


def _criteria(reqs: Request, device=None) -> torch.Tensor:
    """Criteria min-max normalised per column, in f32 with every operand
    and result flushed as XLA does."""
    crit = flush_subnormal(_raw_criteria(reqs, device))
    lo = crit.min(dim=0, keepdim=True).values
    hi = crit.max(dim=0, keepdim=True).values
    den = torch.maximum(flush_subnormal(hi - lo),
                        torch.tensor(1e-9, dtype=torch.float32,
                                     device=crit.device))
    return flush_subnormal(flush_subnormal(crit - lo) / den)


def _rank(crit: torch.Tensor, front: torch.Tensor,
          batch_size: int) -> torch.Tensor:
    """Front members first, then by the criteria sum: up to batch_size
    int32 indices.  The sum adds left to right from +0.0
    (`monotone_score`), and the sort is stable."""
    score = flush_subnormal(monotone_score(crit) + torch.where(
        front, torch.zeros_like(crit[:, 0]),
        torch.full_like(crit[:, 0], 1e3)))
    return stable_argsort(score)[:batch_size].to(torch.int32)


def admit(reqs: Request, batch_size: int, *,
          engine: SkylineEngine | None = None):
    """Pick up to batch_size requests, Pareto front first, then by an
    urgency score.  Returns (indices, front_mask) on the engine's
    device."""
    engine = engine or default_engine()
    crit = _criteria(reqs, engine.device)
    front = engine.member_masks([crit])[0]
    return _rank(crit, front, batch_size), front


def admit_many(queues: Sequence[Request], batch_size: int, *,
               engine: SkylineEngine | None = None):
    """Admission for Q independent queues in one dominance launch per
    size bucket.  Returns a list of (indices, front_mask) pairs, one per
    queue."""
    engine = engine or default_engine()
    crits = [_criteria(r, engine.device) for r in queues]
    fronts = engine.member_masks(crits)
    return [(_rank(c, f, batch_size), f) for c, f in zip(crits, fronts)]


def _rank_rows(rows: np.ndarray, k: int) -> np.ndarray:
    """Up to k criteria rows, most urgent (normalized sum) first."""
    if rows.shape[0] == 0:
        return rows
    lo, hi = rows.min(0, keepdims=True), rows.max(0, keepdims=True)
    score = ((rows - lo) / np.maximum(hi - lo, 1e-9)).sum(-1)
    return rows[np.argsort(score)][:k]


def _snapshot_fronts(stream) -> list[np.ndarray]:
    """Each stream's front rows on the host, in one transfer."""
    buf = stream._snapshot_batch()
    points = buf.points.cpu().numpy()
    mask = buf.mask.cpu().numpy()
    return [points[j][mask[j]] for j in range(stream.q)]


class StreamingAdmitter:
    """Incrementally maintained admission fronts over arriving requests.

    Dominance is evaluated on the *raw* (slack, -priority, cost)
    criteria: the batch normalization `_criteria` applies is a
    per-dimension positive affine map, which never changes skyline
    membership, so the running front equals the front of the full
    request pool at every point in time.

    With ``backfill=True`` a *second layer* is maintained too: the
    skyline of the non-front pool, so `admit` can fill a batch when the
    first-layer front is smaller than ``batch_size``.  A request leaves
    the first layer exactly once (rejected on arrival or evicted later;
    the pool is insert-only) and is fed to a shadow stream at that
    moment, so the shadow's running front is SKY(pool \\ front).
    Detecting demotions reads the front back after each offer (one
    small device read per wave), which is why backfill is opt-in."""

    def __init__(self, *, queues: int = 1,
                 engine: SkylineEngine | None = None,
                 backfill: bool = False):
        self.engine = engine or default_engine()
        self.stream = self.engine.open_stream(3, StreamOptions(q=queues))
        self.queues = queues
        self.backfill = backfill
        if backfill:
            self.shadow = self.engine.open_stream(
                3, StreamOptions(q=queues))
            self._fronts = [np.zeros((0, 3), np.float32)
                            for _ in range(queues)]

    def offer(self, arrivals: Sequence[Request | None]) -> None:
        """Absorb one batch of arrivals per queue (None = no arrivals)
        in one feed wave across all queues."""
        if len(arrivals) != self.queues:
            raise ValueError(f"got {len(arrivals)} arrival batches for "
                             f"{self.queues} queues")
        batches = [None if r is None else _raw_criteria(r)
                   for r in arrivals]
        self.stream.feed(batches)
        if not self.backfill:
            return
        # demotions this wave: arrival rows that did not reach the new
        # front, plus old front rows evicted from it (value equality is
        # the membership test: a duplicate of a front member joins the
        # front itself, so it is never demoted)
        new_fronts = self.fronts()
        demoted: list[np.ndarray | None] = []
        for qi in range(self.queues):
            fset = {r.tobytes()
                    for r in np.ascontiguousarray(new_fronts[qi])}
            rows = [r for r in self._fronts[qi]
                    if r.tobytes() not in fset]
            if batches[qi] is not None:
                rows += [r for r in np.ascontiguousarray(
                    batches[qi].cpu().numpy()) if r.tobytes() not in fset]
            demoted.append(np.asarray(rows, np.float32).reshape(-1, 3)
                           if rows else None)
        self._fronts = [np.ascontiguousarray(f) for f in new_fronts]
        if any(d is not None for d in demoted):
            self.shadow.feed(demoted)

    def fronts(self) -> list[np.ndarray]:
        """Current Pareto-front criteria rows, one (F_i, 3) per queue."""
        return _snapshot_fronts(self.stream)

    def second_layer_fronts(self) -> list[np.ndarray]:
        """SKY(pool \\ front) per queue (requires ``backfill=True``)."""
        if not self.backfill:
            raise ValueError("second layer needs backfill=True")
        return _snapshot_fronts(self.shadow)

    def admit(self, batch_size: int) -> list[np.ndarray]:
        """Up to batch_size front criteria rows per queue, most urgent
        first; with ``backfill=True``, batches short of ``batch_size``
        are topped up from the second layer.  Returns raw criteria rows:
        a streaming pool has no stable request indices to hand back."""
        out = []
        seconds = (self.second_layer_fronts() if self.backfill
                   else [None] * self.queues)
        # with backfill on, offer() just read the primary fronts
        fronts = self._fronts if self.backfill else self.fronts()
        for front, layer2 in zip(fronts, seconds):
            picked = _rank_rows(front, batch_size)
            if layer2 is not None and picked.shape[0] < batch_size:
                fill = _rank_rows(layer2, batch_size - picked.shape[0])
                picked = np.concatenate([picked, fill]) if fill.size \
                    else picked
            out.append(picked)
        return out


class WindowedAdmitter:
    """Admission fronts that *age out*: requests count toward the front
    only for the last ``window_epochs`` ticks.

    The fronts live in a windowed stream: `offer` feeds the current head
    epoch, `tick` rotates the ring for every queue at once (a full ring
    expires its oldest epoch), and `fronts`/`admit` read the
    merge-on-read snapshot: exactly the Pareto front of the requests
    offered in the live window."""

    def __init__(self, *, queues: int = 1, window_epochs: int = 4,
                 engine: SkylineEngine | None = None):
        self.engine = engine or default_engine()
        self.stream = self.engine.open_stream(
            3, StreamOptions(q=queues, window_epochs=window_epochs))
        self.queues = queues
        self.window_epochs = window_epochs

    def offer(self, arrivals: Sequence[Request | None]) -> None:
        """Absorb one batch of arrivals per queue into the head epoch
        (one feed wave across all queues)."""
        if len(arrivals) != self.queues:
            raise ValueError(f"got {len(arrivals)} arrival batches for "
                             f"{self.queues} queues")
        self.stream.feed([None if r is None else _raw_criteria(r)
                          for r in arrivals])

    def tick(self) -> bool:
        """Advance the window clock for every queue; returns whether an
        epoch of requests aged out."""
        return self.stream.tick()

    def fronts(self) -> list[np.ndarray]:
        """Pareto front of the live window per queue, one (F_i, 3)."""
        return _snapshot_fronts(self.stream)

    def admit(self, batch_size: int) -> list[np.ndarray]:
        """Up to batch_size live-window front rows per queue, most
        urgent first."""
        return [_rank_rows(front, batch_size) for front in self.fronts()]
