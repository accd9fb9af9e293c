"""Batched multi-query skyline engine.

Counterpart of ``repro.serve.engine`` on one device.  The serving regime
is many small and medium skyline queries, where per-query launch
overhead costs more than the quadratic dominance work the paper
parallelizes.  The engine amortizes it: Q independent queries (separate
datasets, or preference-scaled views of one dataset) are padded to a
common size bucket, stacked, and answered by ONE run of the batched
partition + local + merge pipeline
(`repro_torch.core.parallel.fused_skyline_batch_fn`): at the default
config two sweep launches per bucket, however many queries it holds.

Query count Q and length N are rounded up to power-of-two buckets (with
floors), so the shapes that reach the kernels are bounded by
#Q-buckets x #N-buckets, whatever ragged sizes users submit
(`pack_trace_count` counts the distinct pack keys used; the port has no
jit cache, so it bounds shapes, not compilations).  Packing is two-level:
a query already on the engine's device is copied into the bucket on the
device; host data is staged into one pinned buffer and sent with one
``non_blocking`` copy; then the validity mask is built on the device
from the lengths.  Padding rows and padding queries are masked out and
every stage is mask-correct, so the answers are the per-query ones.

Streaming: `open_stream` returns a `SkylineStream`: q live skylines
advanced by one `feed` per arriving chunk batch (2 sweep + 2 dominance
launches at the default config, for all q), read by `snapshot()`, bit
for bit the answer over the whole (unexpired) history.  Stream states
live in the engine's slab arenas (`repro_torch.serve.slab`): one
device-resident arena per (d, dtype, epochs, slot-rows) bucket, tenants
lease front-sized slots, and each feed gathers the slots, inserts and
writes the packed fronts back in place (the arenas are the engine's
own, so whatever ``SkyConfig.donate`` says; see
`repro_torch.serve.slab`).  With ``window_epochs=E`` the
streams are sliding windows over an epoch ring
(`repro_torch.core.windowed`).

No stream operation waits on the device.  A front that outgrows its
slot is not written back; the wave's inserted states become a *pending
record*, whose per-slot ``fits`` vector and counts go to pinned host
memory by a ``non_blocking`` copy with a CUDA event behind them.  Reads
and later feeds overlay the record on the device; a poll of the event
(`SkylineStream.poll`, and every stream operation) settles it once it
has arrived, and promotes the stream to a bigger rows bucket.  `drain`
is the blocking settle, for tests and shutdown.

Typical use::

    engine = SkylineEngine(SkyConfig(strategy="sliced", p=8))
    buf, stats = engine.submit(SkylineRequest(data=pts))
    results = engine.submit_many(
        [SkylineRequest(data=pts_a),                  # ragged batch
         SkylineRequest(data=pts, scale=weights[0]),  # preference view
         SkylineRequest(data=pts, subspace=dims[0])])
    fronts = engine.member_masks([crit_a, crit_b])    # admission masks

    stream = engine.open_stream(4, StreamOptions(q=2))  # 2 live skylines
    stream.feed([chunk_a0, chunk_b0])                 # one launch wave
    stream.feed([chunk_a1, None])                     # ragged arrivals
    (buf_a, buf_b) = stream.snapshot()                # canonical fronts

Dispatch is two-path.  Small-query buckets run the one-device batched
pipeline.  When the engine holds a 2-D ``(queries, workers)`` mesh
(`repro_torch.launch.mesh.make_engine_mesh`), buckets whose padded
length reaches ``shard_threshold_n`` run the sharded batch program: the
query batch is cut over the queries axis and each query's partitions
over the workers axis, so large queries engage every rank.  Every rank
of the mesh makes the same calls with the same inputs (the SPMD mapping
of ``launch/mesh.py``) and gets the whole batch's answers; both paths
give the same bits.  Stream arenas are whole on every rank.
`calibrate_shard_threshold` measures the two paths and every
factoring of the mesh, and sets the threshold and the per-bucket
factorings from what it measured.

Entry points run on the card unless the engine is made with
``device="cpu"`` (or with a mesh, on the mesh's device); without CUDA
that raises ``RuntimeError``.  Where the reference takes ``jax.random``
keys the port takes int seeds (ROADMAP.md, contract 5).  The kernel
tuning table is item 11 and not consulted here.
The deprecated per-family entry points (``run`` / ``run_scaled`` /
``run_subspace``, and ``open_stream``'s loose keywords) remain as thin
wrappers over the request API, equal to ``submit_many`` bit for bit.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import time
import warnings
from collections.abc import Mapping
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import incremental, windowed
from repro_torch.core import parallel as par
from repro_torch.core.dominance import (SENTINEL, dominated_mask,
                                        flush_subnormal)
from repro_torch.core.parallel import SkyConfig
from repro_torch.core.sfs import SkyBuffer
from repro_torch.kernels.backend import resolve_device, resolve_spec
from repro_torch.serve.api import (SkylineRequest, StreamOptions,
                                   check_impl_name)
from repro_torch.serve.slab import (SlabArena, blank_value, index_tensor,
                                    slot_rows_bucket)

__all__ = ["SkylineEngine", "SkylineStream", "SkylineRequest",
           "StreamOptions", "pack_trace_count", "calibrate_shard_threshold",
           "tenant_seed"]


def _round_up(size: int, multiple: int) -> int:
    return -(-size // multiple) * multiple


def _next_bucket(size: int, floor: int) -> int:
    """Smallest power of two >= max(size, floor)."""
    b = max(int(floor), 1)
    while b < size:
        b *= 2
    return b


# --------------------------------------------------------------------------
# Seeds: the port's stand-in for the reference's key derivations
# --------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def tenant_seed(*parts: int) -> int:
    """One fixed integer mix (splitmix64 over the parts) to a 63-bit
    seed.  A stream derives each tenant's seed for a feed from (stream
    seed, chunks fed, tenant), where the reference splits
    ``fold_in(key, chunks_fed)``; the same parts give the same seed in a
    coalesced wave and in a serial feed."""
    h = 0
    for p in parts:
        z = (h ^ (int(p) & _M64)) + 0x9E3779B97F4A7C15 & _M64
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & _M64
        z = (z ^ (z >> 27)) * 0x94D049BB133111EB & _M64
        h = z ^ (z >> 31)
    return h >> 1


def _draws(cfg: SkyConfig) -> bool:
    """Whether the pipeline draws random numbers under ``cfg``."""
    return cfg.strategy == "random" or cfg.rep_filter == "random"


def _generators(cfg: SkyConfig, seeds, device):
    """One generator per query seed when ``cfg`` draws, else None."""
    if not _draws(cfg):
        return None
    return [torch.Generator(device=device).manual_seed(int(s))
            for s in seeds]


# --------------------------------------------------------------------------
# Two-level bucketed pack
# --------------------------------------------------------------------------

# Distinct pack keys (kind, qb, nb, d, dtype, masked[, view]) used in
# this process: the shapes that reached the pipeline are bounded by it.
_PACK_KEYS: set[tuple] = set()


def pack_trace_count() -> int:
    """How many distinct pack keys have been used: bounded by the number
    of (Q-bucket, N-bucket, d, dtype, masked) combinations, never by the
    exact ragged sizes submitted.  The reference counts traces of its
    jitted pack programs; the port has no jit cache, so this bounds the
    shapes that reach the kernels."""
    return len(_PACK_KEYS)


def _on(x, device: torch.device) -> bool:
    return isinstance(x, torch.Tensor) and x.device == device


def _stage_rows(arrs, shape, dtype, fill, device) -> torch.Tensor:
    """A (qb, nb, ...) tensor on ``device`` filled with ``fill``, with
    ``arrs[j]`` (None for none) in rows [j, :len(arrs[j])].

    Level 1 of the pack.  Pieces already on ``device`` are copied there;
    the host pieces are staged in one host buffer (pinned when
    ``device`` is the card) and sent by one ``non_blocking`` copy (no
    host sync per query; on the CPU the buffer is the result)."""
    host = [(j, a) for j, a in enumerate(arrs)
            if a is not None and not _on(a, device)]
    if host:
        buf = torch.empty(shape, dtype=dtype,
                          pin_memory=device.type == "cuda")
        buf.fill_(fill)
        for j, a in host:
            buf[j, :a.shape[0]] = torch.as_tensor(a).to(dtype)
        out = buf.to(device, non_blocking=True)
    else:
        out = torch.full(shape, fill, dtype=dtype, device=device)
    for j, a in enumerate(arrs):
        if a is not None and _on(a, device):
            out[j, :a.shape[0]].copy_(a)
    return out


def _unpack(tree: SkyBuffer, q: int) -> list[SkyBuffer]:
    """The first q per-query views of a stacked buffer (no copies)."""
    return [SkyBuffer(*(x[j] for x in tree)) for j in range(q)]


class _SlicedStats(Mapping):
    """Per-query view of a batch's stats, sliced on access (stats are
    read far less often than result buffers)."""

    def __init__(self, stats: dict[str, torch.Tensor], idx: int):
        self._stats = stats
        self._idx = idx

    def __getitem__(self, key):
        return self._stats[key][self._idx]

    def __iter__(self):
        return iter(self._stats)

    def __len__(self):
        return len(self._stats)


class SkylineEngine:
    """Answers batches of independent skyline queries in one launch wave.

    Args:
      cfg: pipeline configuration shared by all queries of this engine.
      min_n_bucket / min_q_bucket: floors of the power-of-two size
        buckets for query length and query count.
      mesh: optional 2-D `repro_torch.launch.mesh.WorkerMesh` carrying
        ``q_axis`` and ``w_axis`` (see ``make_engine_mesh``).  Without
        one, every bucket runs on this rank's device alone.
      shard_threshold_n: padded query length at which a bucket runs the
        sharded program instead of the one-device one (below it, the
        collectives cost more than the dominance work they divide).
      q_axis / w_axis: the mesh's axis names for the query batch and the
        per-query partitions.
      min_slab_rows: the smallest slot a stream tenant leases.
      device: where the engine runs: the card unless ``"cpu"`` is given
        (without CUDA that raises ``RuntimeError``); with a mesh, the
        mesh's device.

    ``cfg.impl`` is resolved for the engine's device at construction, so
    an unknown backend, or ``'cuda'`` on a CPU engine, fails here.
    """

    def __init__(self, cfg: SkyConfig = SkyConfig(), *,
                 min_n_bucket: int = 64, min_q_bucket: int = 4,
                 mesh=None, shard_threshold_n: int = 4096,
                 q_axis: str = "queries", w_axis: str = "workers",
                 min_slab_rows: int = 64, device=None):
        par.check_supported(cfg, mesh)
        if mesh is not None:
            missing = {q_axis, w_axis} - set(mesh.axis_names)
            if missing:
                raise ValueError(f"mesh lacks engine axes {sorted(missing)}"
                                 f"; has {mesh.axis_names}")
            mesh.check_member()
            if device is None:
                device = mesh.device
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # name the card, so that a tensor on it is recognised as such
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.kernel_spec = resolve_spec(cfg.impl, self.device)
        self.cfg = cfg
        self.min_n_bucket = min_n_bucket
        self.min_q_bucket = min_q_bucket
        self.min_slab_rows = min_slab_rows
        self.mesh = mesh
        self.shard_threshold_n = shard_threshold_n
        self.q_axis = q_axis
        self.w_axis = w_axis
        # per-bucket (queries x workers) factorings, set by
        # `calibrate_shard_threshold(..., factorings=True)`: bucket nb ->
        # (qa, wa, merge mode); other buckets use the constructor mesh
        self.factorings: dict[int, tuple[int, int, str]] = {}
        self._arenas: dict[tuple, SlabArena] = {}
        # observed per-stream per-epoch front sizes, keyed (d, epochs):
        # consulted by `open_stream` to size `epoch_capacity`
        self.epoch_front_hist: dict[tuple[int, int],
                                    collections.Counter] = {}
        self.queries_answered = 0
        self.batches_dispatched = 0
        self.sharded_dispatched = 0
        # the serve loop's admission model: per-(d, dtype, n-bucket) wave
        # times in seconds, written by `calibrate_shard_threshold`
        self.wave_time_hints: dict[tuple, float] = {}

    # -- planning ----------------------------------------------------------

    def _use_sharded(self, nb: int) -> bool:
        return self.mesh is not None and nb >= self.shard_threshold_n

    def _mesh_for(self, nb: int | None):
        """The mesh a size-``nb`` bucket runs on: its calibrated
        factoring when one was measured, else the constructor mesh."""
        if self.mesh is None:
            return None
        fact = None if nb is None else self.factorings.get(nb)
        if fact is None:
            return self.mesh
        from repro_torch.launch.mesh import make_engine_mesh
        return make_engine_mesh(fact[0], fact[1], device=self.device,
                                q_axis=self.q_axis, w_axis=self.w_axis,
                                timeout=self.mesh.timeout)

    def _merge_mode_for(self, nb: int | None) -> str | None:
        """The calibrated merge topology of a bucket, or None."""
        fact = None if nb is None else self.factorings.get(nb)
        return fact[2] if fact is not None else None

    def _q_bucket(self, q: int, sharded: bool = False,
                  nb: int | None = None) -> int:
        """Padded query count: a power-of-two bucket, and on the sharded
        path also a multiple of the queries-axis size."""
        if sharded:
            nq = self._mesh_for(nb).queries
            return _round_up(_next_bucket(q, max(self.min_q_bucket, nq)),
                             nq)
        return _next_bucket(q, self.min_q_bucket)

    def _pipeline(self, sharded: bool, nb: int | None = None,
                  cfg: SkyConfig | None = None):
        """The batched program of a bucket: on the bucket's mesh when
        ``sharded`` (with its calibrated merge mode under
        ``merge='auto'``), else on this rank's device."""
        cfg = self.cfg if cfg is None else cfg
        if not sharded:
            return par.fused_skyline_batch_fn(cfg)
        if cfg.merge == "auto" and self._merge_mode_for(nb) is not None:
            cfg = dataclasses.replace(cfg, merge=self._merge_mode_for(nb))
        return par.fused_skyline_batch_fn(cfg, self._mesh_for(nb))

    def _cfg_for(self, impl: str | None) -> SkyConfig:
        """The engine config with a per-request kernel-backend override
        applied.  The reference then consults its kernel tuning table;
        that table is item 11 of ROADMAP.md and is not ported, so the
        config is used as given."""
        cfg = self.cfg
        if impl is not None and impl != cfg.impl:
            check_impl_name(impl)
            return dataclasses.replace(cfg, impl=impl)
        return cfg

    def _run(self, pts_b, mask_b, seeds, cfg: SkyConfig,
             sharded: bool = False):
        """One run of the batched pipeline on a packed bucket."""
        gens = _generators(cfg, seeds, self.device)
        nb = pts_b.shape[1]
        out = self._pipeline(sharded, nb, cfg)(pts_b, mask_b, gens)
        self.batches_dispatched += 1
        self.sharded_dispatched += sharded
        return out

    # -- slab arenas -------------------------------------------------------

    def _arena(self, d: int, dtype, epochs: int, rows: int) -> SlabArena:
        """The shared arena of one (d, dtype, epochs, slot-rows) bucket,
        made on first use (device buffers stay O(#buckets))."""
        key = (int(d), str(dtype).replace("torch.", ""), int(epochs),
               int(rows))
        arena = self._arenas.get(key)
        if arena is None:
            arena = self._arenas[key] = SlabArena(
                epochs=epochs, rows=rows, d=d, dtype=dtype,
                device=self.device)
        return arena

    def arena_report(self) -> dict[tuple, dict[str, int]]:
        """Per-bucket slab accounting (slots / leases / device buffers /
        bytes / growths)."""
        return {k: {"slots": a.capacity, "leased": a.leased,
                    "buffers": a.num_buffers(), "bytes": a.device_bytes(),
                    "grows": a.grows}
                for k, a in self._arenas.items()}

    # -- padding helpers ---------------------------------------------------

    def _group(self, items) -> dict[tuple, list[int]]:
        """Indices grouped by compatible batch key (d, dtype, N-bucket)."""
        groups: dict[tuple, list[int]] = {}
        for i, x in enumerate(items):
            n, d = x.shape
            groups.setdefault(
                (d, "float32", _next_bucket(n, self.min_n_bucket)),
                []).append(i)
        return groups

    def _pack(self, items, masks, idxs, qb: int):
        """Pad and stack the queries at ``idxs`` to (qb, nb, d) points
        and a (qb, nb) validity mask on the engine's device (see
        `_stage_rows`); padding rows hold the sentinel and are masked."""
        idxs = list(idxs)
        ns = [items[i].shape[0] for i in idxs]
        nb = _next_bucket(max(ns), self.min_n_bucket)
        d = items[idxs[0]].shape[1]
        dev = self.device
        any_masked = any(masks[i] is not None for i in idxs)
        _PACK_KEYS.add(("pack", qb, nb, d, "float32", any_masked))
        pts = _stage_rows([items[i] for i in idxs], (qb, nb, d),
                          torch.float32, SENTINEL, dev)
        lengths = index_tensor(ns + [0] * (qb - len(idxs)), dev)
        valid = torch.arange(nb, device=dev)[None, :] < lengths[:, None]
        if any_masked:
            valid &= _stage_rows(
                [None if masks[i] is None else torch.as_tensor(masks[i])
                 for i in idxs], (qb, nb), torch.bool, True, dev)
        return pts, valid

    # -- main entry points (request-oriented) ------------------------------

    def submit(self, request: SkylineRequest,
               ) -> tuple[SkyBuffer, Mapping[str, Any]]:
        """Answer one `SkylineRequest` (see `submit_many`)."""
        return self.submit_many([request])[0]

    def submit_many(self, requests: Sequence[SkylineRequest],
                    ) -> list[tuple[SkyBuffer, Mapping[str, Any]]]:
        """Answer a mixed batch of `SkylineRequest`s, one (SkyBuffer,
        stats) each, in request order.

        Plain requests are grouped by (d, dtype, N-bucket, impl); each
        group is one run of the batched pipeline.  View requests
        (``scale`` / ``subspace``) that share one ``data`` object stack
        their view parameters and go through the broadcast view pack, so
        Q views of one dataset stay one run.  Whenever no bucket
        overflows, results are bit for bit per-query `parallel_skyline`;
        under bucket overflow both drop excess rows and flag it.

        Requests without a ``key`` take their position in the call as
        the seed (the reference splits one default key positionally), so
        an all-plain, all-default batch is the legacy ``run(queries)``
        bit for bit.  Deadlines are ignored here."""
        reqs = list(requests)
        if not reqs:
            return []
        for r in reqs:
            if not isinstance(r, SkylineRequest):
                raise TypeError(f"submit_many wants SkylineRequest items, "
                                f"got {type(r).__name__}")
        out: list[tuple[SkyBuffer, Mapping[str, Any]] | None] = \
            [None] * len(reqs)

        def _key_for(i):
            return i if reqs[i].key is None else reqs[i].key

        groups: dict[tuple, list[int]] = {}
        vgroups: dict[tuple, list[int]] = {}
        for i, r in enumerate(reqs):
            n, d = r.data.shape
            if r.view_kind is None:
                kb = (d, "float32", _next_bucket(n, self.min_n_bucket),
                      r.impl)
                groups.setdefault(kb, []).append(i)
            else:
                mk = id(r.mask) if r.mask is not None else None
                vgroups.setdefault((id(r.data), r.view_kind, mk, r.impl),
                                   []).append(i)
        for (_, _, nb, impl), idxs in groups.items():
            sharded = self._use_sharded(nb)
            qb = self._q_bucket(len(idxs), sharded, nb)
            pts_b, mask_b = self._pack([reqs[i].data for i in idxs],
                                       [reqs[i].mask for i in idxs],
                                       range(len(idxs)), qb)
            seeds = [_key_for(i) for i in idxs] + [0] * (qb - len(idxs))
            bufs, stats = self._run(pts_b, mask_b, seeds,
                                    self._cfg_for(impl), sharded)
            for j, (i, buf) in enumerate(zip(idxs,
                                             _unpack(bufs, len(idxs)))):
                out[i] = (buf, _SlicedStats(stats, j))
        for (_, kind, _, impl), idxs in vgroups.items():
            r0 = reqs[idxs[0]]
            params = [reqs[i].scale if kind == "scale" else
                      reqs[i].subspace for i in idxs]
            # all-default keys draw one seed per *bucket row*, as the
            # reference's view path does
            keys = (None if all(reqs[i].key is None for i in idxs)
                    else [_key_for(i) for i in idxs])
            res = self._run_stacked(r0.data, params, r0.mask, keys, kind,
                                    cfg=self._cfg_for(impl))
            for j, i in enumerate(idxs):
                out[i] = res[j]
        self.queries_answered += len(reqs)
        return out  # type: ignore[return-value]

    def _run_stacked(self, pts, params: Sequence, mask, keys,
                     kind: str, cfg: SkyConfig | None = None,
                     ) -> list[tuple[SkyBuffer, Mapping[str, Any]]]:
        """Q views of one (N, d) dataset in one run: the dataset is
        staged once at (nb, d), the Q (d,) view parameter rows at (qb, d)
        (stacked on the device when all lie there, else staged as in
        `_stage_rows`: no host read of a card-resident row), and the
        (qb, nb, d) views are built on the device.  Scale views
        multiply in f32 and flush as XLA does
        (`core.dominance.flush_subnormal`); subspace views zero the
        ignored attributes."""
        cfg = self.cfg if cfg is None else cfg
        n, d = pts.shape
        q = len(params)
        nb = _next_bucket(n, self.min_n_bucket)
        sharded = self._use_sharded(nb)
        qb = self._q_bucket(q, sharded, nb)
        dev = self.device
        _PACK_KEYS.add(("view", qb, nb, d, "float32", mask is not None,
                        kind))
        staged = _stage_rows([pts], (1, nb, d), torch.float32, SENTINEL,
                             dev)[0]
        pdt = torch.bool if kind == "subspace" else torch.float32
        if all(_on(r, dev) for r in params):
            params_b = torch.zeros((qb, d), dtype=pdt, device=dev)
            params_b[:q] = torch.stack(list(params)).to(pdt)
        else:
            params_b = _stage_rows([torch.as_tensor(np.asarray(r))
                                    if not isinstance(r, torch.Tensor) else r
                                    for r in params], (qb, d), pdt, 0, dev)
        valid = ((torch.arange(nb, device=dev)[None, :] < n)
                 & (torch.arange(qb, device=dev)[:, None] < q))
        if mask is not None:
            m = torch.as_tensor(mask).bool().broadcast_to((n,))
            valid &= _stage_rows([m], (1, nb), torch.bool, False, dev)
        if kind == "scale":
            views = flush_subnormal(flush_subnormal(staged)[None]
                                    * flush_subnormal(params_b)[:, None])
        else:  # subspace: ignored attributes zeroed (non-discriminating)
            views = torch.where(params_b[:, None, :], staged[None], 0.0)
        pts_b = torch.where(valid[..., None], views,
                            torch.full_like(views, SENTINEL))
        seeds = (list(range(qb)) if keys is None
                 else list(keys) + [0] * (qb - q))
        bufs, stats = self._run(pts_b, valid, seeds, cfg, sharded)
        return [(buf, _SlicedStats(stats, j))
                for j, buf in enumerate(_unpack(bufs, q))]

    # -- legacy entry points (deprecated wrappers over the request API) ----

    def run(self, queries, *, masks=None, keys=None,
            ) -> list[tuple[SkyBuffer, Mapping[str, Any]]]:
        """Deprecated: build `SkylineRequest`s and call `submit_many`."""
        warnings.warn("SkylineEngine.run is deprecated; submit "
                      "SkylineRequest objects via submit()/submit_many()",
                      DeprecationWarning, stacklevel=2)
        q = len(queries)
        if q == 0:
            return []
        if masks is None:
            masks = [None] * q
        if keys is None:
            keys = list(range(q))
        elif len(keys) != q:
            raise ValueError(f"got {len(keys)} keys for {q} queries")
        return self.submit_many([
            SkylineRequest(data=x, mask=m, key=keys[i])
            for i, (x, m) in enumerate(zip(queries, masks))])

    def run_scaled(self, pts, weights, *, mask=None, keys=None,
                   ) -> list[tuple[SkyBuffer, Mapping[str, Any]]]:
        """Deprecated: Q preference-scaled views of one dataset
        (``weights`` is (Q, d) positive per-attribute scales); submit
        `SkylineRequest(data=pts, scale=w)` instead."""
        warnings.warn("SkylineEngine.run_scaled is deprecated; submit "
                      "SkylineRequest(data=..., scale=...) via "
                      "submit()/submit_many()",
                      DeprecationWarning, stacklevel=2)
        if np.ndim(weights) != 2 or np.shape(weights)[1] != pts.shape[1]:
            raise ValueError("weights must be (Q, d)")
        return self._legacy_views(pts, weights, mask, keys, "scale")

    def run_subspace(self, pts, dim_masks, *, mask=None, keys=None,
                     ) -> list[tuple[SkyBuffer, Mapping[str, Any]]]:
        """Deprecated: Q subspace-skyline views of one dataset
        (``dim_masks`` is (Q, d) bool; ignored attributes are zeroed);
        submit `SkylineRequest(data=pts, subspace=m)` instead."""
        warnings.warn("SkylineEngine.run_subspace is deprecated; submit "
                      "SkylineRequest(data=..., subspace=...) via "
                      "submit()/submit_many()",
                      DeprecationWarning, stacklevel=2)
        if (np.ndim(dim_masks) != 2
                or np.shape(dim_masks)[1] != pts.shape[1]):
            raise ValueError("dim_masks must be (Q, d) bool")
        return self._legacy_views(pts, dim_masks, mask, keys, "subspace")

    def _legacy_views(self, pts, params, mask, keys, kind: str):
        rows = (params if isinstance(params, torch.Tensor)
                else np.asarray(params))
        if keys is not None and len(keys) != rows.shape[0]:
            raise ValueError(f"got {len(keys)} keys for {rows.shape[0]} "
                             f"views")
        return self.submit_many([
            SkylineRequest(data=pts, mask=mask,
                           scale=rows[i] if kind == "scale" else None,
                           subspace=rows[i] if kind == "subspace" else None,
                           key=None if keys is None else keys[i])
            for i in range(rows.shape[0])])

    def member_masks(self, crits, *, masks=None) -> list[torch.Tensor]:
        """Skyline *membership masks* (input order) for Q criteria sets:
        per size bucket ONE batched dominance launch of the packed
        points against themselves."""
        q = len(crits)
        if q == 0:
            return []
        if masks is None:
            masks = [None] * q
        dom_impl = resolve_spec(self.cfg.impl, self.device).dominance
        out: list[torch.Tensor | None] = [None] * q
        for idxs in self._group(crits).values():
            qb = _next_bucket(len(idxs), self.min_q_bucket)
            pts_b, mask_b = self._pack(crits, masks, idxs, qb)
            res = mask_b & ~dominated_mask(pts_b, pts_b, mask_b,
                                           impl=dom_impl)
            self.batches_dispatched += 1
            for j, i in enumerate(idxs):
                out[i] = res[j, :crits[i].shape[0]]
        self.queries_answered += q
        return out  # type: ignore[return-value]

    # -- streaming ---------------------------------------------------------

    def record_epoch_fronts(self, d: int, epochs: int, counts) -> None:
        """Fold observed per-epoch front sizes (a (q, epochs) array a
        stream's `counters`/`close` read) into the union-size histogram;
        zero entries carry no sizing information and are dropped."""
        sizes = np.asarray(counts).reshape(-1)
        sizes = sizes[sizes > 0]
        if sizes.size == 0:
            return
        hist = self.epoch_front_hist.setdefault(
            (int(d), int(epochs)), collections.Counter())
        hist.update(int(s) for s in sizes)

    def suggest_epoch_capacity(self, d: int, epochs: int) -> int:
        """Data-derived ``epoch_capacity`` for a new (d, epochs) windowed
        stream: 0 until 8 epoch fronts were observed, then 2x the largest
        observed front rounded up to the block, if that shrinks the
        slots below the full state capacity."""
        hist = self.epoch_front_hist.get((int(d), int(epochs)))
        if hist is None or sum(hist.values()) < 8:
            return 0
        block = self.cfg.block
        sug = -(-2 * max(hist) // block) * block
        if sug >= incremental.state_capacity(self.cfg):
            return 0
        return sug

    def open_stream(self, d: int, options: StreamOptions | None = None,
                    **legacy) -> "SkylineStream":
        """Open ``options.q`` live skylines over ``d``-attribute tuples
        in the engine's slab arenas (see `SkylineStream`).  Loose
        keywords (``q=``, ``window_epochs=``, ...) still work but are
        deprecated.  A windowed stream that left ``epoch_capacity`` unset
        takes `suggest_epoch_capacity`'s."""
        if legacy:
            if options is not None:
                raise ValueError("pass either a StreamOptions or legacy "
                                 "keywords, not both")
            unknown = set(legacy) - {"q", "dtype", "key", "window_epochs",
                                     "epoch_capacity"}
            if unknown:
                raise TypeError(f"open_stream got unexpected keywords "
                                f"{sorted(unknown)}")
            warnings.warn("open_stream(**knobs) is deprecated; pass "
                          "open_stream(d, StreamOptions(...))",
                          DeprecationWarning, stacklevel=2)
            options = StreamOptions(**legacy)
        elif options is None:
            options = StreamOptions()
        if options.window_epochs is not None and not options.epoch_capacity:
            sug = self.suggest_epoch_capacity(d, options.window_epochs)
            if sug:
                options = dataclasses.replace(options, epoch_capacity=sug)
        return SkylineStream(self, d=d, options=options)


# --------------------------------------------------------------------------
# Slab programs: gather leased slots, insert, write the packed fronts back
# in place.  Every index a program takes is a tensor on the device.
# --------------------------------------------------------------------------

def _lead(sel: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``sel`` (B,) shaped to broadcast over ``like``'s trailing axes."""
    return sel.reshape((-1,) + (1,) * (like.ndim - 1))


def _gather_slots(leaves, idx: torch.Tensor):
    return tuple(a.index_select(0, idx) for a in leaves)


def _rows(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], device=x.device)


def _sub_of_epoch(gathered, heads: torch.Tensor, c: int):
    """Each gathered slot's ``heads[i]`` epoch as a batched
    `SkylineState`, rows padded to ``c``."""
    ar = _rows(heads)
    sub = incremental.SkylineState(*(a[ar, heads] for a in gathered))
    points, mask = incremental._fit_rows(sub.points, sub.mask, c)
    return sub._replace(points=points, mask=mask)


def _put_epoch(gathered, sub, heads: torch.Tensor, rows: int,
               take: torch.Tensor):
    """The gathered leaves with ``sub`` in each slot's ``heads[i]``
    epoch where ``take[i]``, truncated to ``rows`` (callers take only
    fronts that fit).  Written into ``gathered`` itself: the gathered
    leaves are the caller's own ``index_select`` copies, read no more
    after this."""
    sub = sub._replace(points=sub.points[:, :rows], mask=sub.mask[:, :rows])
    ar = _rows(heads)
    out = []
    for a, v in zip(gathered, sub):
        a[ar, heads] = torch.where(_lead(take, v), v, a[ar, heads])
        out.append(a)
    return tuple(out)


def _pending_sub(rec_sub, pos: torch.Tensor, c: int):
    """A pending record's inserted states at wave rows ``pos``, rows
    fitted to ``c``."""
    psub = incremental.SkylineState(*(a.index_select(0, pos)
                                      for a in rec_sub))
    points, mask = incremental._fit_rows(psub.points, psub.mask, c)
    return psub._replace(points=points, mask=mask)


def _splice_pending(fitted, rec_sub, pos, sel, eps):
    """Overlay a pending record onto gathered slot leaves: for each slot
    with ``sel[i]``, the record's row ``pos[i]`` replaces ring slot
    ``eps[i]``.  The record is the authoritative value for its (slot,
    epoch) whether or not the conditional write installed it."""
    psub = _pending_sub(rec_sub, pos, fitted[0].shape[-2])
    ar = _rows(eps)
    out = []
    for leaf, val in zip(fitted, psub):
        upd = leaf.clone()
        upd[ar, eps] = val
        out.append(torch.where(_lead(sel, leaf), upd, leaf))
    return tuple(out)


def _slab_feed(cfg: SkyConfig, arena: SlabArena, rows: int, q: int,
               cap: int, idx, heads, pts, mask, generators, pend,
               mesh=None):
    """One wave: gather the leased slots of one or more streams sharing
    a bucket, overlay the chained pending records onto their head
    epochs, run the batched insert (2 sweep + 2 dominance launches at
    the default config) and write each of the first ``q`` slots back in
    place, only where its front fits its ``rows`` (``torch.where`` on
    the device; ``fits`` is never read on the host here).  With a 2-D
    ``mesh`` the insert is the sharded batch insert; the arena is whole
    on every rank.  Returns the ``cap``-row inserted states, ``fits``
    and the insert's stats."""
    leaves = arena.leaves()
    gathered = _gather_slots(leaves, idx)
    sub = _sub_of_epoch(gathered, heads, cap)
    for rec_sub, p_pos, p_sel, p_eps in pend:
        psub = _pending_sub(rec_sub, p_pos, cap)
        sel = p_sel & (p_eps == heads)
        sub = incremental.SkylineState(*(
            torch.where(_lead(sel, a), pa, a) for a, pa in zip(sub, psub)))
    # sub2 becomes the wave's pending record, a shared overlay: it is
    # never written in place
    sub2, stats = incremental._insert_batch(sub, pts, mask, cfg=cfg,
                                            generator=generators, mesh=mesh)
    # a slot at the epoch-capacity ceiling can never outgrow it
    fits = (torch.ones((q,), dtype=torch.bool, device=pts.device)
            if rows >= cap else sub2.count[:q] <= rows)
    arena.write(idx[:q], _put_epoch(
        tuple(g[:q] for g in gathered),
        incremental.SkylineState(*(x[:q] for x in sub2)), heads[:q], rows,
        fits))
    return sub2, fits, stats


def _slab_promote(old_leaves, idx, eps, rec_sub, pos, take, new_rows: int):
    """The (q, E, new_rows, ...) slot values of q streams moving to a
    bigger rows bucket: the old slots re-padded, with the pending wave's
    inserted states spliced in at each tenant's recorded epoch where
    ``take``."""
    gathered = _gather_slots(old_leaves, idx)
    points, mask = incremental._fit_rows(gathered[0], gathered[1],
                                         new_rows)
    gathered = (points, mask) + gathered[2:]
    sub = incremental.SkylineState(*(a.index_select(0, pos)
                                     for a in rec_sub))
    return _put_epoch(gathered, sub, eps, new_rows, take)


def _slab_clear_epoch(arena: SlabArena, slots: np.ndarray,
                      epoch: np.ndarray, sel: np.ndarray) -> None:
    """Blank one epoch ring slot per selected tenant, in place (the
    O(1) expiry: nothing is recomputed, merge-on-read resolves the
    rest).  The selection is on the host, so only the selected (slot,
    epoch) pairs are written."""
    dev = arena.device
    s = index_tensor(slots[sel], dev)
    e = index_tensor(epoch[sel], dev)
    for a in arena.leaves():
        # the blank value made on the device: a Python scalar would be
        # copied from pageable host memory, a host sync
        a.index_put_((s, e), torch.full((), blank_value(a.dtype),
                                        dtype=a.dtype, device=dev))


def _slab_snapshot(cfg: SkyConfig, arena: SlabArena, idx, epochs: int,
                   pend) -> SkyBuffer:
    """Canonical snapshot of leased slots: unbounded streams (E == 1)
    put their antichain in the canonical order (no launch); windowed
    streams merge the epoch ring on read (one sweep launch, or one
    dominance launch under NoSeq).  Pending records are overlaid
    first."""
    c = incremental.state_capacity(cfg)
    gathered = _gather_slots(arena.leaves(), idx)
    points, mask = incremental._fit_rows(gathered[0], gathered[1], c)
    fitted = (points, mask) + gathered[2:]
    for args in pend:
        fitted = _splice_pending(fitted, *args)
    points, mask, count, overflow, seen, chunks = fitted
    if epochs == 1:
        return incremental.finalize(incremental.SkylineState(
            points[:, 0], mask[:, 0], count[:, 0], overflow[:, 0],
            seen[:, 0], chunks[:, 0]), cfg=cfg)
    zero = torch.zeros((), dtype=torch.int32, device=points.device)
    return windowed.finalize(windowed.WindowedSkylineState(
        points, mask, count, overflow, seen, chunks, head=zero,
        active=zero + epochs), cfg=cfg)


class _WaveRecord:
    """One wave's inserted states (the ``cap``-row ``sub``) and its
    per-slot ``fits`` and counts, on their way to the host: on the card
    a ``non_blocking`` copy into pinned memory with an event recorded
    behind it; on the CPU they are there at once."""

    def __init__(self, sub, fits: torch.Tensor):
        self.sub = tuple(sub)
        counts = sub.count
        if fits.device.type == "cuda":
            self._fits = torch.empty(fits.shape, dtype=fits.dtype,
                                     pin_memory=True)
            self._counts = torch.empty(counts.shape, dtype=counts.dtype,
                                       pin_memory=True)
            self._fits.copy_(fits, non_blocking=True)
            self._counts.copy_(counts, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self._fits, self._counts, self.event = fits, counts, None

    def ready(self) -> bool:
        """Non-blocking: have ``fits`` and the counts arrived?"""
        return self.event is None or self.event.query()

    def wait(self) -> None:
        """Block until they have (the sanctioned sync of `drain`)."""
        if self.event is not None:
            self.event.synchronize()

    def host_fits(self) -> np.ndarray:
        """The per-slot ``fits`` vector on the host (read once `ready`
        or `wait` says it arrived)."""
        return self._fits.numpy()

    def host_counts(self) -> np.ndarray:
        """The per-slot front sizes on the host (as `host_fits`)."""
        return self._counts.numpy()


class _Pending:
    """One stream's share of a wave's deferred slot-overflow record.

    ``pos`` maps this stream's tenants into the wave's rows, ``epochs``
    snapshots each tenant's ring slot at feed time, and ``alive`` tracks
    which entries are still the authoritative value for their (slot,
    epoch): a tick that clears the slot kills the entry, and a chained
    feed into the same slot supersedes it.  Until the poll finds the
    record ready, every read and chained feed overlays it on the
    device."""

    __slots__ = ("record", "pos", "epochs", "alive")

    def __init__(self, record: _WaveRecord, pos, epochs, alive):
        self.record = record
        self.pos = pos
        self.epochs = epochs
        self.alive = alive


class _WaveStats(Mapping):
    """Per-stream view of a wave's stats: rows [off, off + q) of each
    leaf, sliced on access."""

    def __init__(self, stats: dict[str, torch.Tensor], off: int, q: int):
        self._stats = stats
        self._off = off
        self._q = q

    def __getitem__(self, key):
        return self._stats[key][self._off:self._off + self._q]

    def __iter__(self):
        return iter(self._stats)

    def __len__(self):
        return len(self._stats)


def _record_args(members, wb: int, device) -> tuple:
    """(record sub, pos, sel, epochs) device arguments of one record,
    from its members' (offset, q, pending) entries."""
    p_pos = np.zeros((wb,), np.int64)
    p_sel = np.zeros((wb,), bool)
    p_eps = np.zeros((wb,), np.int64)
    for off, sq, p in members:
        p_pos[off:off + sq] = p.pos
        p_sel[off:off + sq] = p.alive
        p_eps[off:off + sq] = p.epochs
    return (members[0][2].record.sub, index_tensor(p_pos, device),
            index_tensor(p_sel, device).bool(), index_tensor(p_eps, device))


def _wave_feed(engine: SkylineEngine, parts) -> Mapping:
    """ONE coalesced gather + insert + write wave for the feeds of one or
    more `SkylineStream`s sharing a slab bucket (``parts`` is a list of
    (stream, items, masks)).

    The members' chunks are packed together, their slot indices and ring
    heads concatenate into one wave, and each tenant's seed is derived
    exactly as a serial feed derives it (`tenant_seed`), so a coalesced
    wave is bit for bit the members fed one by one.  Each member's share
    of the wave's deferred record becomes its `_Pending`; the host never
    reads the device here."""
    for s, _, _ in parts:
        s._maybe_resolve()
    groups: dict[tuple, list] = {}
    for part in parts:
        s = part[0]
        groups.setdefault((id(s.arena), s.rows, s.cap), []).append(part)
    if len(groups) > 1:
        # a promotion just split the bucket: one wave per sub-bucket
        stats = None
        for group in groups.values():
            stats = _wave_feed(engine, group)
        return stats
    s0 = parts[0][0]
    arena, rows, cap = s0.arena, s0.rows, s0.cap
    dev = engine.device
    total = sum(p[0].q for p in parts)
    wb = engine._q_bucket(total, engine.mesh is not None)
    items: list = []
    masks: list = []
    idx: list[int] = []
    heads: list[int] = []
    seeds: list[int] = []
    for s, its, ms in parts:
        items += its
        masks += ms
        idx += s._idx().tolist()  # raises if the stream closed
        heads += s._head.tolist()
        seeds += [tenant_seed(s._seed, s.chunks_fed, t)
                  for t in range(s.q)]
    pts_b, mask_b = engine._pack(items, masks, range(total), wb)
    sharded = engine._use_sharded(pts_b.shape[1])
    pad = wb - total
    # chain every live record of every member; records shared by several
    # members (an earlier coalesced wave) enter once, entries merged
    recs: dict[int, list] = {}
    off = 0
    for s, _, _ in parts:
        for p in s._pendings:
            if p.alive.any():
                recs.setdefault(id(p.record), []).append((off, s.q, p))
        off += s.q
    pend = [_record_args(members, wb, dev) for members in recs.values()]
    sub2, fits, stats = _slab_feed(
        engine.cfg, arena, rows, total, cap,
        index_tensor(idx + [idx[0]] * pad, dev),
        index_tensor(heads + [heads[0]] * pad, dev), pts_b, mask_b,
        _generators(engine.cfg, seeds + [0] * pad, dev), pend,
        engine.mesh if sharded else None)
    record = _WaveRecord(sub2, fits) if rows < cap else None
    off = 0
    for s, _, _ in parts:
        # this wave's write supersedes the chained head-epoch entries
        for p in s._pendings:
            p.alive &= ~(p.epochs == s._head)
        s._pendings = [p for p in s._pendings if p.alive.any()]
        if record is not None:
            s._pendings.append(_Pending(
                record, pos=np.arange(off, off + s.q),
                epochs=s._head.copy(), alive=np.ones((s.q,), bool)))
        s.last_stats = _WaveStats(stats, off, s.q)
        s.chunks_fed += 1
        off += s.q
    engine.batches_dispatched += 1
    engine.sharded_dispatched += sharded
    return stats


class SkylineStream:
    """Q live skylines fed incrementally through a `SkylineEngine`.

    The stream leases one slot per live skyline from the slab arena of
    its (d, dtype, epochs, slot-rows) bucket; each tenant's resident
    footprint is its slot's row count, a power of two tracking its
    front, promoted to the next bucket when the front outgrows it.
    Every `feed` is one wave (`_wave_feed`); `snapshot` returns
    canonical per-stream `SkyBuffer`s bit for bit the one-shot answer
    over the unexpired history.  No stream operation waits on the
    device (see the module docstring); `drain` is the blocking settle.

    With ``window_epochs=E`` the streams are sliding windows: `tick()`
    opens a new epoch for all q tenants or a subset (a full ring expires
    its oldest epoch in O(1)), `expire_epoch()` drops tails without
    opening one, and `snapshot` merges the ring on read.  Each tenant's
    ring clock is kept on the host and reaches the device as data."""

    def __init__(self, engine: SkylineEngine, *, d: int,
                 options: StreamOptions | None = None):
        if options is None:
            options = StreamOptions()
        self.engine = engine
        self.options = options
        self.q = options.q
        self.d = d
        self.dtype = options.dtype
        self.window_epochs = options.window_epochs
        self.epochs = int(options.window_epochs or 1)
        self.epoch_capacity = int(options.epoch_capacity)
        # the slot-row ceiling: epoch_capacity (rounded to the block)
        # for windowed streams that declared one, else the state capacity
        self.cap = windowed.epoch_rows(engine.cfg, self.epoch_capacity)
        self.rows = slot_rows_bucket(1, engine.min_slab_rows, self.cap)
        self.arena = engine._arena(d, self.dtype, self.epochs, self.rows)
        self.slots = self.arena.lease(self.q)
        self._pendings: list[_Pending] = []
        self._head = np.zeros((self.q,), np.int64)
        self._active = np.ones((self.q,), np.int64)
        # the seed of every tenant's draws (host-side: an idle stream
        # holds no device tensor)
        self._seed = 0 if options.key is None else int(options.key)
        self.chunks_fed = 0
        self.ticks = 0
        self.last_stats: Mapping | None = None

    @property
    def windowed(self) -> bool:
        return self.window_epochs is not None

    def _idx(self) -> np.ndarray:
        if not self.slots:
            raise ValueError("stream is closed (slots released)")
        return np.asarray(self.slots, np.int64)

    def _idx_tensor(self) -> torch.Tensor:
        return index_tensor(self._idx(), self.engine.device)

    def _tenant_sel(self, tenants) -> np.ndarray:
        if tenants is None:
            return np.ones((self.q,), bool)
        sel = np.zeros((self.q,), bool)
        for t in tenants:
            t = int(t)
            if not 0 <= t < self.q:
                raise ValueError(f"tenant {t} out of range for "
                                 f"q={self.q}")
            sel[t] = True
        if not sel.any():
            raise ValueError("need at least one tenant")
        return sel

    def _pend_args(self) -> list:
        """(record sub, pos, sel, epochs) device arguments, one per live
        pending record (may be empty)."""
        dev = self.engine.device
        return [_record_args([(0, self.q, p)], self.q, dev)
                for p in self._pendings if p.alive.any()]

    # -- async pending settlement ------------------------------------------

    def _maybe_resolve(self) -> None:
        """Settle, WITHOUT blocking, exactly the records whose ``fits``
        the device has delivered; the others keep being overlaid."""
        for p in list(self._pendings):
            if not p.alive.any():
                self._pendings.remove(p)
            elif p.record.ready():
                self._finish_resolve(p)

    def poll(self) -> bool:
        """Non-blocking maintenance poll: settle every record whose
        ``fits`` has arrived.  Returns True while records remain."""
        self._maybe_resolve()
        return bool(self._pendings)

    def _force_resolve(self) -> None:
        while self._pendings:
            self._pendings[0].record.wait()
            self._finish_resolve(self._pendings[0])

    def _finish_resolve(self, pend: _Pending) -> None:
        self._pendings.remove(pend)
        if not pend.alive.any():
            return
        bad = pend.alive & ~pend.record.host_fits()[pend.pos]
        if bad.any():
            # some front outgrew its slot: move to a rows bucket holding
            # the largest such front
            counts = pend.record.host_counts()[pend.pos]
            self._promote(int(counts[bad].max()), pend)

    def drain(self) -> "SkylineStream":
        """Block until every deferred slot-overflow check has settled
        (promoting where a front outgrew its slot): the sanctioned sync
        of tests and shutdown; `feed`/`tick`/`snapshot` never wait."""
        self._force_resolve()
        return self

    def _promote(self, need: int, pend: _Pending) -> None:
        """Move this stream's slots to the rows bucket that holds
        ``need`` front rows, splicing the pending wave's inserted states
        in at each tenant's recorded epoch; the old slots go back to
        their arena's free list."""
        eng = self.engine
        dev = eng.device
        new_rows = slot_rows_bucket(need, eng.min_slab_rows, self.cap)
        idx = self._idx_tensor()
        vals = _slab_promote(
            self.arena.leaves(), idx, index_tensor(pend.epochs, dev),
            pend.record.sub, index_tensor(pend.pos, dev),
            index_tensor(pend.alive, dev).bool(), max(new_rows, self.rows))
        if new_rows <= self.rows:
            # an earlier resolve already promoted past this need
            self.arena.write(idx, vals)
            return
        new_arena = eng._arena(self.d, self.dtype, self.epochs, new_rows)
        new_slots = new_arena.lease(self.q)
        new_arena.write(index_tensor(new_slots, dev), vals)
        self.arena.release(self.slots)
        self.arena, self.slots, self.rows = new_arena, new_slots, new_rows

    def feed(self, chunks, *, masks=None) -> "SkylineStream":
        """Absorb one arriving chunk per stream (``None`` / length 0 for
        streams with no new data) in one wave (windowed streams: into
        each tenant's head epoch).  Never waits on the device."""
        items, mlist = self._feed_args(chunks, masks)
        _wave_feed(self.engine, [(self, items, mlist)])
        return self

    def _feed_args(self, chunks, masks) -> tuple[list, list]:
        """Validate one feed's per-stream chunk/mask lists."""
        if len(chunks) != self.q:
            raise ValueError(f"got {len(chunks)} chunks for {self.q} "
                             f"streams")
        if masks is None:
            masks = [None] * self.q
        elif len(masks) != self.q:
            raise ValueError(f"got {len(masks)} masks for {self.q} "
                             f"streams")
        items = [np.zeros((0, self.d), np.float32) if c is None else c
                 for c in chunks]
        for c in items:
            if tuple(c.shape[1:]) != (self.d,):
                raise ValueError(f"chunk shape {tuple(c.shape)} does not "
                                 f"match stream d={self.d}")
        return items, list(masks)

    # -- epoch ring (windowed streams) -------------------------------------

    def tick(self, tenants: Sequence[int] | None = None) -> bool:
        """Open a new head epoch for every tenant, or only the listed
        ones; for a tenant with a full ring, clearing the claimed slot
        IS the expiry (O(1)).  Returns whether a selected tenant expired
        an epoch."""
        if not self.windowed:
            raise ValueError("tick() needs a windowed stream "
                             "(StreamOptions(window_epochs=E))")
        self._maybe_resolve()
        sel = self._tenant_sel(tenants)
        new_head, new_active, expired = windowed.ring_advance(
            self._head, self._active, self.epochs)
        _slab_clear_epoch(self.arena, self._idx(), new_head, sel)
        for p in self._pendings:
            # entries whose ring slot was just cleared die with it
            p.alive &= ~(sel & (p.epochs == new_head))
        self._head = np.where(sel, new_head, self._head)
        self._active = np.where(sel, new_active, self._active)
        self.ticks += 1
        self.engine.batches_dispatched += 1
        return bool(np.any(expired & sel))

    def expire_epoch(self, tenants: Sequence[int] | None = None,
                     ) -> "SkylineStream":
        """Drop the tail epoch of the selected tenants (default: all) in
        O(1) without opening a new one."""
        if not self.windowed:
            raise ValueError("expire_epoch() needs a windowed stream")
        self._maybe_resolve()
        sel = self._tenant_sel(tenants)
        tail = windowed.ring_tail(self._head, self._active, self.epochs)
        _slab_clear_epoch(self.arena, self._idx(), tail, sel)
        for p in self._pendings:
            p.alive &= ~(sel & (p.epochs == tail))
        self._active = np.where(sel, np.maximum(self._active - 1, 1),
                                self._active)
        self.engine.batches_dispatched += 1
        return self

    # -- reads -------------------------------------------------------------

    def _snapshot_batch(self) -> SkyBuffer:
        self._maybe_resolve()
        return _slab_snapshot(self.engine.cfg, self.arena,
                              self._idx_tensor(), self.epochs,
                              self._pend_args())

    def snapshot(self) -> list[SkyBuffer]:
        """Canonical `SkyBuffer` per live stream (non-destructive), with
        any unresolved overflow record overlaid on the device: the read
        never waits on the host."""
        return _unpack(self._snapshot_batch(), self.q)

    def counters(self) -> dict[str, np.ndarray]:
        """Per-stream running stats, read to the host (a sanctioned
        sync).  For windowed streams ``count`` is the retained-candidate
        total (the window front size needs `snapshot`)."""
        self._maybe_resolve()
        gathered = _gather_slots(self.arena.leaves(), self._idx_tensor())
        for args in self._pend_args():
            gathered = _splice_pending(gathered, *args)
        _, _, count, overflow, seen, chunks = gathered
        per_epoch = count.cpu().numpy()
        self.engine.record_epoch_fronts(self.d, self.epochs, per_epoch)
        return {"count": per_epoch.sum(axis=1, dtype=np.int32),
                "seen": seen.sum(dim=1, dtype=torch.int32).cpu().numpy(),
                "chunks": chunks.sum(dim=1,
                                     dtype=torch.int32).cpu().numpy(),
                "overflow": overflow.any(dim=1).cpu().numpy()}

    def close(self) -> None:
        """Return the leased slots to the arena free list.  A stream
        that was fed leaves its per-epoch front sizes in the engine's
        histogram on the way out (one `counters` read)."""
        if self.slots and self.chunks_fed:
            self.counters()
        self._pendings = []
        if self.slots:
            self.arena.release(self.slots)
            self.slots = []


def _candidate_factorings(engine: SkylineEngine,
                          d: int) -> list[tuple[int, int]]:
    """Every (queries x workers) factoring of the engine mesh's rank
    count whose workers size divides cfg's partition count at ``d``."""
    ndev = engine.mesh.size
    p, _ = par.effective_parts(engine.cfg, d)
    return [(ndev // wa, wa) for wa in range(1, ndev + 1)
            if ndev % wa == 0 and p % wa == 0]


def _best_time(fn, repeat: int, device: torch.device) -> float:
    """Seconds of the fastest of ``repeat`` calls of ``fn`` after one
    warm-up: CUDA events on the card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(repeat):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
            t = time.perf_counter() - t0
        best = min(best, t)
    return best


def calibrate_shard_threshold(engine: SkylineEngine, *,
                              bucket_sizes: Sequence[int] = (1024, 4096,
                                                            16384),
                              q: int | None = None, d: int = 4,
                              repeat: int = 3, apply: bool = True,
                              factorings: bool = True) -> dict[str, Any]:
    """Measure the one-device batch against the sharded program at a few
    N buckets and set ``engine.shard_threshold_n`` (and, with
    ``factorings=True``, each bucket's (queries x workers) factoring and
    merge mode) from the measurements.  The reference's calibration.

    Each bucket's synthetic batch is packed once and timed through the
    one-device pipeline and every candidate factoring of the mesh's
    ranks (best of ``repeat`` after a warm-up); the winning factoring is
    timed again under ``merge='tree'``, and the faster topology becomes
    its merge mode.  The threshold is the smallest measured bucket from
    which the sharded program wins at every larger measured bucket (none:
    ``sys.maxsize``, the engine stays on one device).  Every rank times
    its own calls; each time taken is the largest over the mesh, so that
    every rank makes the same choice.  grid and angular derive p from
    d, so no factoring is stored for them.  Returns the report
    (``threshold_n``, per-bucket timings in seconds, the factorings as
    ``"QxW:mode"``); ``apply=False`` leaves the engine as it was."""
    if engine.mesh is None:
        return {"applied": False, "threshold_n": engine.shard_threshold_n,
                "measurements": {}, "factorings": {},
                "reason": "no mesh: vmap-only engine"}
    from repro_torch.launch.mesh import make_engine_mesh
    mesh0, dev = engine.mesh, engine.device
    if engine.cfg.strategy not in ("sliced", "random"):
        factorings = False
    q = q or max(mesh0.queries, engine.min_q_bucket)
    own = (mesh0.queries, mesh0.workers)
    cands = _candidate_factorings(engine, d) if factorings else [own]
    meshes = {f: mesh0 if f == own else make_engine_mesh(
        f[0], f[1], device=dev, q_axis=engine.q_axis, w_axis=engine.w_axis,
        timeout=mesh0.timeout) for f in cands}

    def agree(times):
        return [float(t) for t in mesh0.max_over_mesh(
            torch.tensor(times, dtype=torch.float64))]

    def timed(queries, cfg, mesh, qb):
        pts_b, mask_b = engine._pack(queries, [None] * q, range(q), qb)
        fn = par.fused_skyline_batch_fn(cfg, mesh)
        gens = _generators(cfg, range(qb), dev)
        return _best_time(lambda: fn(pts_b, mask_b, gens), repeat, dev)

    measurements: dict[int, dict[str, Any]] = {}
    chosen: dict[int, tuple[int, int, str]] = {}
    for size in sorted(set(bucket_sizes)):
        nb = _next_bucket(size, engine.min_n_bucket)
        if nb in measurements:
            continue
        rng = np.random.default_rng(nb)
        queries = [rng.random((nb, d), dtype=np.float32) for _ in range(q)]
        qb_of = {f: _round_up(_next_bucket(q, max(engine.min_q_bucket,
                                                  f[0])), f[0])
                 for f in cands}
        times = agree([timed(queries, engine.cfg, None,
                             _next_bucket(q, engine.min_q_bucket))]
                      + [timed(queries, engine.cfg, meshes[f], qb_of[f])
                         for f in cands])
        per_fact = {f"{f[0]}x{f[1]}": t for f, t in zip(cands, times[1:])}
        best_name = min(per_fact, key=per_fact.get)
        best = cands[list(per_fact).index(best_name)]
        tree_t, = agree([timed(queries,
                               dataclasses.replace(engine.cfg, merge="tree"),
                               meshes[best], qb_of[best])])
        mode = "tree" if tree_t < per_fact[best_name] else "flat"
        chosen[nb] = (best[0], best[1], mode)
        measurements[nb] = {
            "vmap": times[0], "sharded": min(per_fact[best_name], tree_t),
            "factorings": per_fact, "best_factoring": best_name,
            "merge": {"flat": per_fact[best_name], "tree": tree_t},
            "best_merge": mode}
    sizes = sorted(measurements)
    threshold = sys.maxsize
    for i, nb in enumerate(sizes):
        if all(measurements[m]["sharded"] < measurements[m]["vmap"]
               for m in sizes[i:]):
            threshold = nb
            break
    if apply:
        engine.shard_threshold_n = threshold
        if factorings:
            engine.factorings.update(chosen)
        for nb, t in measurements.items():
            engine.wave_time_hints[(d, "float32", nb)] = min(
                t["vmap"], t["sharded"])
    return {"applied": apply, "threshold_n": threshold,
            "measurements": measurements,
            "factorings": ({nb: f"{f[0]}x{f[1]}:{f[2]}"
                            for nb, f in chosen.items()}
                           if factorings else {})}
