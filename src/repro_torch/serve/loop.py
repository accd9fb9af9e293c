"""Async continuous-batching serve loop over `SkylineEngine`.

Counterpart of ``repro.serve.loop``.  The engine answers synchronous
calls; skyline serving is a request *stream* with deadlines.
`ServeLoop` turns the engine into that front-end with the
dispatch-ahead shape of LLM serving stacks:

  intake  ->  admission  ->  coalesce  ->  pack+dispatch   (staging
                                            thread, never waits on the
                                            device)
                               device executes wave k
              completion thread observes wave k finishing while the
              staging thread is already packing wave k+1

* **Dispatch-ahead double buffering.** Up to ``depth`` waves are in
  flight: the staging thread stages (the engine's level-1 host pack)
  and dispatches wave k+1 while the device still executes wave k.  A
  wave's completion is a CUDA event recorded right after its last
  dispatch; a separate completion thread waits on it
  (``Event.synchronize`` releases the interpreter lock), so the staging
  thread never blocks on the device.  ``depth=1`` disables the overlap
  (the A/B knob of the reference's ``serving_latency`` benchmark).  On a
  CPU engine the work is done when it is dispatched, and a wave has no
  event.

* **One stream.** Every wave runs on the stream that was current on the
  engine's device when the loop was made, which is the stream the
  caller's `SkylineStream.snapshot` and synchronous calls use.  Program
  order on that stream is what makes the arena's in-place writes safe
  between wave k and wave k+1.

* **Cross-tenant feed coalescing.** Pending `SkylineStream.feed` work
  items whose streams lease from the same slab bucket fuse into ONE
  gather+insert+write wave (`repro_torch.serve.engine._wave_feed`), bit
  for bit equal to feeding the streams serially.  A stream fed twice in
  one wave takes a second round, in order (`_rounds`).

* **Deadline-aware admission with load shedding.** Work items carry an
  absolute deadline (a ``time.monotonic`` instant).  The scheduler
  processes earliest-deadline-first, sheds items that the EWMA
  wave-time model says cannot meet their deadline (or *degrades* them,
  answering a query on every other row of its data, when
  ``degrade=True``), and under queue overload sheds
  oldest-deadline-first until the backlog fits.

Every stream mutation happens on the staging thread, so streams need no
locks; the completion thread only waits on events and resolves tickets.
No serving path waits on the device: overflow promotion rides the
engine's pending records, polled by the staging thread when it is idle;
`drain` is the only explicit settle, for shutdown and tests.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Sequence

import torch

from repro_torch.serve.api import SkylineRequest
from repro_torch.serve.engine import (SkylineEngine, SkylineStream,
                                      _next_bucket, _wave_feed)

__all__ = ["ServeLoop", "Ticket"]


class Ticket:
    """Future handed back by `ServeLoop.submit` / `ServeLoop.feed`.

    ``status`` is ``"pending"`` until the completion thread resolves it
    to ``"ok"`` (``result``/``latency`` are set; ``degraded`` marks a
    query answered on subsampled data to meet its deadline), the
    admission controller resolves it to ``"shed"``, or its wave raised
    (``"error"``, with the exception as ``result``).
    """

    __slots__ = ("kind", "request", "stream", "chunks", "masks",
                 "deadline", "submitted_at", "status", "result",
                 "latency", "degraded", "_event")

    def __init__(self, kind, *, request=None, stream=None, chunks=None,
                 masks=None, deadline=None, submitted_at=0.0):
        self.kind = kind            # "query" | "feed"
        self.request = request
        self.stream = stream
        self.chunks = chunks
        self.masks = masks
        self.deadline = deadline
        self.submitted_at = submitted_at
        self.status = "pending"
        self.result = None
        self.latency = None
        self.degraded = False
        self._event = threading.Event()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> "Ticket":
        if not self._event.wait(timeout):
            raise TimeoutError("ticket not resolved in time")
        return self


class _Wave:
    """One in-flight dispatch: the tickets it answers, the CUDA event
    recorded after its last dispatch (None on the CPU), the wave-time
    model buckets it updates, and its clock."""

    __slots__ = ("tickets", "event", "keys", "staged_at", "dispatched_at")

    def __init__(self, tickets, event, keys, staged_at, dispatched_at):
        self.tickets = tickets
        self.event = event
        self.keys = keys
        self.staged_at = staged_at
        self.dispatched_at = dispatched_at


_STOP = object()


def _rounds(feeds: list[Ticket]) -> list[list[Ticket]]:
    """Split one bucket's feeds into rounds holding each stream at most
    once, the k-th feed of a stream in round k: one `_wave_feed`
    gathers a stream's slots once, so a second feed of it in the same
    call would be written over by the first.  (The reference fuses them
    into one wave and keeps only one of the chunks.)"""
    rounds: list[list[Ticket]] = []
    seen: dict[int, int] = {}
    for t in feeds:
        k = seen.get(id(t.stream), 0)
        seen[id(t.stream)] = k + 1
        if k == len(rounds):
            rounds.append([])
        rounds[k].append(t)
    return rounds


def _dtype_name(dtype) -> str:
    """A numpy or torch dtype named alike ("float32"), as the engine keys
    its arenas and ``wave_time_hints``."""
    return str(dtype).replace("torch.", "")


class ServeLoop:
    """Continuous-batching front-end: feed it `SkylineRequest`s and
    stream feeds, get `Ticket` futures back.

    ``depth`` is the dispatch-ahead window (1 = no overlap);
    ``max_wave`` caps the work items fused per wave; ``max_queue``
    bounds the backlog (beyond it, oldest-deadline-first shedding);
    ``degrade`` lets at-risk queries run on subsampled data instead of
    being shed.  Use as a context manager, or call
    `start_serving`/`close`.
    """

    def __init__(self, engine: SkylineEngine, *, depth: int = 2,
                 max_wave: int = 8, max_queue: int = 1024,
                 degrade: bool = False, ewma_alpha: float = 0.25,
                 clock=time.monotonic):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if max_wave < 1:
            raise ValueError(f"max_wave must be >= 1, got {max_wave}")
        self.engine = engine
        self.depth = depth
        self.max_wave = max_wave
        self.max_queue = max_queue
        self.degrade = degrade
        self._alpha = ewma_alpha
        self._clock = clock
        dev = engine.device
        self._stream = (torch.cuda.current_stream(dev)
                        if dev.type == "cuda" else None)
        self._queue: collections.deque[Ticket] = collections.deque()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._inflight = 0
        self._stopping = False
        self._started = False
        self._done_q: collections.deque = collections.deque()
        self._done_ev = threading.Event()
        # streams with unresolved pending overflow records, polled by
        # the staging thread whenever it would otherwise sit idle
        self._watch: dict[int, SkylineStream] = {}
        # wave-time model for admission: a per-(d, dtype, rows-bucket)
        # EWMA table of dispatch->complete times, seeded from the
        # engine's calibration timings (`engine.wave_time_hints`);
        # `_ewma` is the catch-all scalar for buckets with no entry yet
        self._ewma = 0.0
        self._ewma_tab: dict[tuple, float] = dict(
            getattr(engine, "wave_time_hints", {}) or {})
        self.stats = {"completed": 0, "shed": 0, "degraded": 0,
                      "waves": 0, "coalesced_feeds": 0,
                      "stage_overlap_s": 0.0}

    # -- lifecycle ---------------------------------------------------------

    def start_serving(self) -> "ServeLoop":
        if self._started:
            return self
        self._started = True
        self._stager = threading.Thread(target=self._stage_loop,
                                        name="skyline-serve-stage",
                                        daemon=True)
        self._completer = threading.Thread(target=self._complete_loop,
                                           name="skyline-serve-complete",
                                           daemon=True)
        self._stager.start()
        self._completer.start()
        return self

    def __enter__(self) -> "ServeLoop":
        return self.start_serving()

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Flush the backlog, wait for in-flight waves, stop threads,
        then settle the watched streams' pending records (every wave has
        completed, so their fits vectors have arrived)."""
        if not self._started:
            return
        with self._work:
            self._stopping = True
            self._work.notify_all()
        self._stager.join()
        self._done_q.append(_STOP)
        self._done_ev.set()
        self._completer.join()
        self._started = False
        with self._on_device():
            self._poll_watched()

    def drain(self) -> "ServeLoop":
        """Block until every accepted item has resolved (the sanctioned
        synchronization point: serving calls never wait)."""
        with self._work:
            self._work.wait_for(
                lambda: not self._queue and self._inflight == 0)
        return self

    # -- intake ------------------------------------------------------------

    def submit(self, request: SkylineRequest) -> Ticket:
        """Enqueue one skyline query; its optional ``deadline`` rides
        into admission control."""
        if not isinstance(request, SkylineRequest):
            raise TypeError("submit() takes a SkylineRequest")
        t = Ticket("query", request=request, deadline=request.deadline,
                   submitted_at=self._clock())
        self._enqueue(t)
        return t

    def feed(self, stream: SkylineStream,
             chunks: Sequence, *, masks: Sequence | None = None,
             deadline: float | None = None) -> Ticket:
        """Enqueue one stream feed; feeds for streams sharing a slab
        bucket coalesce into one wave dispatch."""
        items, mlist = stream._feed_args(chunks, masks)
        t = Ticket("feed", stream=stream, chunks=items, masks=mlist,
                   deadline=deadline, submitted_at=self._clock())
        self._enqueue(t)
        return t

    def _enqueue(self, t: Ticket) -> None:
        if not self._started:
            raise RuntimeError("serve loop is not running (use `with "
                               "ServeLoop(engine):` or call "
                               "start_serving())")
        with self._work:
            self._queue.append(t)
            self._work.notify_all()

    # -- staging thread ----------------------------------------------------

    def _on_device(self):
        """The engine's card and the loop's stream, entered by both
        threads; nothing on a CPU engine."""
        if self._stream is None:
            return contextlib.nullcontext()
        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.cuda.device(self.engine.device))
        ctx.enter_context(torch.cuda.stream(self._stream))
        return ctx

    def _stage_loop(self) -> None:
        with self._on_device():
            while True:
                with self._work:
                    # the dispatch-ahead gate sits BEFORE staging: with
                    # depth=1 nothing is staged until the previous wave
                    # fully completed (no overlap); with depth=k the
                    # host stages wave k+1 while the device runs wave
                    # k.  While streams hold pending overflow records
                    # the wait wakes on a short timeout so idle time
                    # drains them eagerly.
                    self._work.wait_for(
                        lambda: (self._queue and self._inflight < self.depth)
                        or self._stopping,
                        timeout=(self._POLL_S if self._watch else None))
                    if self._stopping and not self._queue:
                        return
                    batch: list[Ticket] = []
                    if self._queue and (self._inflight < self.depth
                                        or self._stopping):
                        batch = self._admit_locked()
                        if batch:
                            self._inflight += 1
                if not batch:
                    self._poll_watched()
                    continue
                try:
                    wave = self._stage_once(batch)
                except Exception as exc:  # the loop outlives a failed wave
                    self._fail(batch, exc)
                    continue
                self._done_q.append(wave)
                self._done_ev.set()

    _POLL_S = 0.002  # idle pending-drain poll interval

    def _fail(self, batch: list[Ticket], exc: Exception) -> None:
        """A wave that raised while staging: its tickets resolve to
        ``"error"`` carrying the exception, and the loop goes on."""
        for t in batch:
            t.status = "error"
            t.result = exc
            t._event.set()
        with self._work:
            self._inflight -= 1
            self._work.notify_all()

    def _poll_watched(self) -> None:
        """Idle-time maintenance on the staging thread (the single
        stream mutator, so streams stay lock-free): non-blocking poll
        of every stream holding pending overflow records; each record
        is released, with the full-capacity sub-state it pins, as soon
        as the device has delivered its fits vector, instead of at the
        stream's next serving op."""
        for sid in list(self._watch):
            if not self._watch[sid].poll():
                del self._watch[sid]

    def _admit_locked(self) -> list[Ticket]:
        """Pop the next wave's work items, earliest deadline first;
        shed what the wave-time model says cannot make it (callers hold
        the lock)."""
        now = self._clock()
        if len(self._queue) > self.max_queue:
            # overload: shed oldest-deadline-first until the backlog
            # fits (items with no deadline are kept: they can wait)
            dated = sorted((t for t in self._queue
                            if t.deadline is not None),
                           key=lambda t: t.deadline)
            doomed = set()
            excess = len(self._queue) - self.max_queue
            for t in dated[:excess]:
                doomed.add(id(t))
                self._shed(t)
            self._queue = collections.deque(
                t for t in self._queue if id(t) not in doomed)
        order = sorted(self._queue,
                       key=lambda t: (t.deadline is None, t.deadline,
                                      t.submitted_at))
        batch: list[Ticket] = []
        for t in order[:self.max_wave]:
            self._queue.remove(t)
            est = now + self._wave_time(self._model_key(t)) \
                * (self._inflight + 1)
            if t.deadline is not None and est > t.deadline:
                if self.degrade and t.kind == "query" \
                        and t.request.data.shape[0] > 1:
                    # answer on every other row instead of not at all;
                    # sliced where the data lies (no read to the host)
                    mask = t.request.mask
                    t.request = dataclasses.replace(
                        t.request, data=t.request.data[::2],
                        mask=None if mask is None else mask[::2])
                    t.degraded = True
                    self.stats["degraded"] += 1
                else:
                    self._shed(t)
                    continue
            batch.append(t)
        return batch

    def _shed(self, t: Ticket) -> None:
        t.status = "shed"
        self.stats["shed"] += 1
        t._event.set()

    # -- wave-time model ---------------------------------------------------

    def _model_key(self, t: Ticket) -> tuple:
        """The EWMA-table bucket of one work item: (d, dtype, rows
        bucket): slot rows for stream feeds, the padded query-length
        bucket for queries (the same keys `engine.wave_time_hints`
        seeds)."""
        if t.kind == "feed":
            s = t.stream
            return (s.d, _dtype_name(s.dtype), s.rows)
        data = t.request.data
        n, d = data.shape
        return (d, _dtype_name(data.dtype),
                _next_bucket(n, self.engine.min_n_bucket))

    def _wave_time(self, key: tuple) -> float:
        """Modeled wave time for one bucket: its EWMA entry, falling
        back to the cross-bucket scalar until the bucket has history
        (the reference's kernel-tuning floor waits for ROADMAP item
        11)."""
        t = self._ewma_tab.get(key)
        return self._ewma if t is None else t

    def _stage_once(self, batch: list[Ticket]) -> _Wave:
        """Pack and dispatch one wave WITHOUT waiting on the device:
        queries go through `SkylineEngine.submit_many` (one bucketed run
        per group), same-bucket stream feeds fuse via `_wave_feed`.
        Returns the in-flight record whose event the completion thread
        waits on."""
        staged_at = self._clock()
        queries = [t for t in batch if t.kind == "query"]
        feeds = [t for t in batch if t.kind == "feed"]
        if queries:
            results = self.engine.submit_many(
                [t.request for t in queries])
            for t, res in zip(queries, results):
                t.result = res
        if feeds:
            waves: dict[tuple, list] = {}
            for t in feeds:
                s = t.stream
                s._maybe_resolve()  # promotions change the bucket key
                waves.setdefault((id(s.arena), s.rows, s.cap),
                                 []).append(t)
            for group in waves.values():
                for part in _rounds(group):
                    _wave_feed(self.engine,
                               [(t.stream, t.chunks, t.masks) for t in part])
                    self.stats["coalesced_feeds"] += len(part) - 1
                    for t in part:
                        t.result = t.stream.last_stats
                        if t.stream._pendings:
                            self._watch[id(t.stream)] = t.stream
        event = None
        if self._stream is not None:
            # ready exactly when everything the wave enqueued on the
            # loop's stream is: the answers, stats and arena writes
            event = torch.cuda.Event()
            event.record(self._stream)
        self.stats["waves"] += 1
        keys = sorted({self._model_key(t) for t in batch})
        return _Wave(batch, event, keys, staged_at, self._clock())

    # -- completion thread -------------------------------------------------

    def _complete_loop(self) -> None:
        with self._on_device():
            while True:
                while not self._done_q:
                    self._done_ev.wait()
                    self._done_ev.clear()
                wave = self._done_q.popleft()
                if wave is _STOP:
                    return
                if wave.event is not None:
                    wave.event.synchronize()  # releases the GIL
                self._complete(wave)

    def _complete(self, wave: _Wave) -> None:
        done_at = self._clock()
        wave_time = done_at - wave.dispatched_at
        for t in wave.tickets:
            t.status = "ok"
            t.latency = done_at - t.submitted_at
            self.stats["completed"] += 1
            t._event.set()
        with self._work:
            self._ewma = (wave_time if self._ewma == 0.0 else
                          self._alpha * wave_time
                          + (1 - self._alpha) * self._ewma)
            for k in wave.keys:
                prev = self._ewma_tab.get(k)
                self._ewma_tab[k] = (
                    wave_time if prev is None else
                    self._alpha * wave_time
                    + (1 - self._alpha) * prev)
            self.stats["stage_overlap_s"] += max(
                0.0, wave.dispatched_at - wave.staged_at)
            self._inflight -= 1
            self._work.notify_all()
