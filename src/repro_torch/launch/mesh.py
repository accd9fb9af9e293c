"""Worlds, meshes and collectives of the port over ``torch.distributed``.

Counterpart of ``repro.launch.mesh`` (the skyline library's meshes:
``make_worker_mesh``, ``make_engine_mesh``, ``engine_mesh_shape``) and
of the named-axis collectives the reference's ``shard_map`` bodies
call.  This is the one module of the port that imports
``torch.distributed`` (lint rule R4, ``analysis.rules.COMPAT_MODULE``).

The SPMD mapping.  JAX's mesh is single-controller: one program sees
every device.  ``torch.distributed`` runs one process per rank, so the
port maps the reference's placement onto replicated calls:

* *One process per rank, replicated calls.*  Every rank calls the same
  entry point with the same inputs, and gets the same answer.
* *The partition stage runs whole on every rank.*  It runs before the
  reference's sharding constraint, so it is a replicated computation
  there too.  Then each rank keeps its contiguous block of partitions,
  ``[w·p/W, (w+1)·p/W)``, which is what ``P(axis_name)`` assigns.  The
  random strategy and ``rep_filter='random'`` draw the whole query on
  every rank from the same generator, then slice, so the mesh answer
  equals the one-device answer (ROADMAP.md, contract 5).
* *The workers group.*  The merge's collectives run over it: the flat
  merge's ``all_gather`` of the local skylines, the tree merge's
  ⌈log₂ W⌉ ``ppermute`` rounds and its root broadcast.  The result is
  replicated over that group.
* *The 2-D layout.*  Rank = ``qi·W + wi`` for a (queries x workers)
  mesh.  A batch of Q queries is cut into ``queries`` equal shards;
  the ranks of shard ``qi`` compute its queries (the reference's
  ``out_specs=P(q_axis)``).
* *Reading a whole batch.*  The whole batch is then assembled over the
  queries group (`WorkerMesh.assemble_queries`), as JAX's read of a
  sharded array, or XLA's resharding of it, assembles it outside the
  named-axis program.  The verifier's census reports this assembly
  apart and does not count it as a collective of the program.

So every entry point given a mesh takes whole, replicated inputs and
returns whole, replicated outputs (states included).

Backends.  ``device=None`` means the card, with NCCL and one rank per
card; ``device="cpu"`` means gloo; without CUDA and without
``device="cpu"`` the constructors raise ``RuntimeError``.  Ranks that
share one card (a world larger than the card count) use gloo, since
NCCL refuses two ranks on one device.  Gloo takes CUDA tensors for some
collectives and not for others; the kinds it does not take are staged
through pinned host memory.  That staging is a property of the backend,
fixed when the world is made (`SHARED_CARD_STAGED`), never reached by
catching an error, and never used under NCCL.

Every collective wrapper records itself to the verifier's census as one
operation, by kind and group (`repro_torch.kernels.backend
.collective_call`), as a kernel call does; a rank outside a round's
partial permutation still records the round.  Every collective moves
bits: tensors travel as integers of their width, so ``-0.0`` and NaN
payloads arrive as they left.  Every group is made with a timeout, so a
rank that never arrives fails the others instead of hanging them.

Spawned worlds.  `World` spawns W processes (the ``spawn`` context),
joins them through a file store (no port is opened) and keeps them for
many runs: ``world.run(fn, *args)`` calls ``fn(*args)`` in every rank
and returns each rank's result.  `run_world` is one such run in a world
made and closed for it.  Every run has a deadline: a rank that fails
fails the run, and a rank that does not answer in time gets the world
killed.  The mesh tests, ``verify_world`` and ``chip_smoke.py``'s
step M spawn their worlds through it.

``make_production_mesh`` and ``make_local_mesh`` (the LLM template
side's meshes) are item 14 of ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.kernels.backend import collective_call, resolve_device

__all__ = ["WorkerMesh", "World", "init_world", "close_world", "world_size",
           "file_store", "run_world", "make_worker_mesh", "make_engine_mesh",
           "engine_mesh_shape", "TIMEOUT_S", "SHARED_CARD_STAGED"]

# seconds a collective waits for the other ranks before it fails
TIMEOUT_S = 120.0

# collective kinds that gloo does not take on CUDA tensors: staged
# through pinned host memory when ranks share a card (held by
# chip_smoke.py's step M on the card)
SHARED_CARD_STAGED = frozenset({"ppermute"})

# integer dtype of each element width: collectives move bits
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

_MESHES: dict[tuple, "WorkerMesh"] = {}


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(seconds))


def init_world(rank: int, size: int, *, store=None, init_method=None,
               device=None, timeout: float = TIMEOUT_S) -> torch.device:
    """Join a world of ``size`` ranks as ``rank``; returns this rank's
    device.

    The rendezvous is ``store`` (a ``torch.distributed`` store, such as
    ``FileStore(path, size)``) or ``init_method`` (``"tcp://localhost:
    <port>"``); a world of one needs neither.  On the card (``device``
    None or ``"cuda"``) rank r takes card ``r % count``, and the backend
    is NCCL when every rank has its own card, else gloo (ranks share
    cards).  ``device="cpu"`` takes gloo."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", rank % cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if size <= cards else "gloo"
    else:
        backend = "gloo"
    if store is None and init_method is None:
        if size != 1:
            raise ValueError("a world of more than one rank needs a store "
                             "or an init_method")
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, init_method=init_method,
                            rank=rank, world_size=size,
                            timeout=_timeout(timeout))
    return dev


def file_store(path: str, size: int):
    """A rendezvous store for a world of ``size`` ranks in the file at
    ``path`` (no port is opened)."""
    return dist.FileStore(path, size)


def close_world() -> None:
    """Leave the world (a no-op outside one); cached meshes go with it."""
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """Ranks in the world (1 outside one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


class World:
    """``size`` spawned ranks joined into one world through the file
    store at ``store`` (on ``device``: see `init_world`; each collective
    waits ``timeout`` seconds), kept until `close`.  ``run(fn, *args)``
    calls ``fn(*args)`` in every rank (``fn`` a module-level function,
    its arguments and result picklable) and returns the results in rank
    order; it raises ``RuntimeError`` with the tracebacks when a rank
    fails, and kills the world when a rank does not answer within
    ``deadline`` seconds."""

    def __init__(self, size: int, store: str, *, device="cpu",
                 timeout: float = TIMEOUT_S):
        ctx = multiprocessing.get_context("spawn")
        self.size = size
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(size)]
        self.procs = [ctx.Process(target=_serve_rank,
                                  args=(r, size, str(store), device, timeout,
                                        self.tasks[r], self.results),
                                  daemon=True) for r in range(size)]
        for proc in self.procs:
            proc.start()

    def run(self, fn, *args, deadline: float) -> list:
        for tasks in self.tasks:
            tasks.put((fn, args))
        out: list = [None] * self.size
        errors = []
        end = time.monotonic() + deadline
        for _ in range(self.size):
            try:
                rank, ok, payload = self.results.get(
                    timeout=max(end - time.monotonic(), 0.01))
            except queue.Empty:
                self.kill()
                raise RuntimeError(
                    f"{fn.__name__}: a rank of {self.size} did not answer "
                    f"within {deadline} s; the world was killed") from None
            if ok:
                out[rank] = payload
            else:
                errors.append(f"rank {rank}:\n{payload}")
        if errors:
            raise RuntimeError(f"{fn.__name__} failed:\n" + "\n".join(errors))
        return out

    def kill(self) -> None:
        for proc in self.procs:
            if proc.is_alive():
                proc.kill()
        for proc in self.procs:
            proc.join(5)

    def close(self) -> None:
        """Let every rank leave the world, then stop what is left."""
        for tasks in self.tasks:
            tasks.put(None)
        end = time.monotonic() + 20
        for proc in self.procs:
            proc.join(max(end - time.monotonic(), 0.01))
        self.kill()


def _serve_rank(rank, size, store, device, timeout, tasks, results) -> None:
    """A rank of `World`: join the world, then run each task sent."""
    try:
        dev = init_world(rank, size, store=file_store(store, size),
                         device=device, timeout=timeout)
    except Exception:  # the parent's run reports the traceback
        results.put((rank, False, traceback.format_exc()))
        return
    if dev.type == "cpu":
        torch.set_num_threads(1)
    while (item := tasks.get()) is not None:
        fn, args = item
        try:
            results.put((rank, True, fn(*args)))
        except Exception:  # the parent's run reports the traceback
            results.put((rank, False, traceback.format_exc()))
    close_world()


def run_world(fn, size: int, *args, device="cpu", deadline: float,
              timeout: float = TIMEOUT_S) -> list:
    """``fn(*args)`` in every rank of a `World` of ``size`` made for this
    one run (its store in a temporary directory, removed after); each
    rank's result, in rank order."""
    with tempfile.TemporaryDirectory() as tmp:
        world = World(size, os.path.join(tmp, "store"), device=device,
                      timeout=timeout)
        try:
            return world.run(fn, *args, deadline=deadline)
        finally:
            world.close()


def _ensure_world(device) -> torch.device:
    """This rank's device, joining a world of one when there is none."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        return init_world(0, 1, device=dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _as_bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(_BITS[x.element_size()])


@dataclasses.dataclass(eq=False)
class WorkerMesh:
    """A (queries x workers) mesh of ranks: rank ``qi·workers + wi`` of
    the world holds mesh position (qi, wi).  A 1-D workers mesh has
    ``queries == 1``.  A mesh may take a prefix of the world's ranks;
    ``member`` says whether this rank is in it.

    ``w_group`` / ``q_group`` are this rank's workers and queries
    groups (None outside the mesh), ``w_ranks`` / ``q_ranks`` their
    world ranks in group order, ``staged`` the collective kinds staged
    through pinned host memory (empty unless ranks share a card)."""
    device: torch.device
    backend: str
    rank: int
    queries: int
    workers: int
    q_index: int | None
    w_index: int | None
    w_group: object
    q_group: object
    w_ranks: tuple
    q_ranks: tuple
    staged: frozenset
    q_axis: str = "queries"
    w_axis: str = "workers"
    timeout: float = TIMEOUT_S
    all_group: object = None

    @property
    def member(self) -> bool:
        return self.w_index is not None

    @property
    def size(self) -> int:
        return self.queries * self.workers

    @property
    def axis_names(self) -> tuple[str, str]:
        return (self.q_axis, self.w_axis)

    @property
    def shape(self) -> dict[str, int]:
        return {self.q_axis: self.queries, self.w_axis: self.workers}

    def check_member(self) -> None:
        if not self.member:
            raise ValueError(f"rank {self.rank} is outside this "
                             f"{self.queries} x {self.workers} mesh")

    # -- collectives of the program (recorded by the census) ---------------

    def _group(self, axis: str):
        if axis == self.w_axis:
            return "workers", self.w_group, self.w_ranks
        if axis == self.q_axis:
            return "queries", self.q_group, self.q_ranks
        raise ValueError(f"unknown axis {axis!r}; have {self.axis_names}")

    def _on_bits(self, kind: str, fn):
        """``x -> fn(bits of x)`` back in ``x``'s dtype and device,
        through pinned host memory when the backend stages ``kind``."""
        def call(x):
            bits = _as_bits(x)
            if kind in self.staged and bits.device.type == "cuda":
                host = torch.empty(bits.shape, dtype=bits.dtype,
                                   pin_memory=True)
                host.copy_(bits)
                out = fn(host).to(bits.device, non_blocking=True)
            else:
                out = fn(bits)
            return out.view(x.dtype)
        return call

    def _gather(self, axis: str, dim: int):
        _, group, ranks = self._group(axis)

        def gather(bits):
            out = [torch.empty_like(bits) for _ in ranks]
            dist.all_gather(out, bits, group=group)
            return torch.cat(out, dim=dim)

        return self._on_bits("all_gather", gather)

    def all_gather(self, x: torch.Tensor, dim: int = 0, *,
                   axis: str | None = None) -> torch.Tensor:
        """``x`` of every rank of the group (the workers group unless
        ``axis`` names the queries axis), concatenated along ``dim`` in
        group order (``lax.all_gather(..., tiled=True)``)."""
        axis = axis or self.w_axis
        return collective_call("all_gather", self._group(axis)[0],
                               self._gather(axis, dim), x)

    def ppermute(self, x: torch.Tensor, pairs) -> torch.Tensor:
        """``lax.ppermute`` over the workers group: for each (src, dst)
        pair of worker indices, dst receives src's ``x``; a worker that
        receives nothing gets zeros of ``x``'s shape.  A worker sends or
        receives, not both, in one call (the tree merge's rounds are
        such), so the point-to-point calls cannot wait on each other."""
        pairs = [(int(s), int(t)) for s, t in pairs]
        if {s for s, _ in pairs} & {t for _, t in pairs}:
            raise ValueError(f"a worker both sends and receives in {pairs}")
        me, ranks, group = self.w_index, self.w_ranks, self.w_group

        def permute(bits):
            out = torch.zeros_like(bits)
            for src, dst in pairs:
                if src == me:
                    dist.send(bits, ranks[dst], group=group)
                elif dst == me:
                    dist.recv(out, ranks[src], group=group)
            return out

        return collective_call("ppermute", "workers",
                               self._on_bits("ppermute", permute), x)

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.ppermute`` over the workers group with the pairs
        ``(i, i + 1)``: worker i + 1 receives worker i's ``x``, worker 0
        gets zeros.  A middle worker both sends and receives; an even
        worker sends first and an odd one receives first, so each send
        meets a receive already waiting or about to wait, down the
        chain."""
        me, ranks, group = self.w_index, self.w_ranks, self.w_group
        last = len(ranks) - 1

        def permute(bits):
            out = torch.zeros_like(bits)
            calls = []
            if me < last:
                calls.append(lambda: dist.send(bits, ranks[me + 1],
                                               group=group))
            if me > 0:
                calls.append(lambda: dist.recv(out, ranks[me - 1],
                                               group=group))
            for call in (calls if me % 2 == 0 else calls[::-1]):
                call()
            return out

        return collective_call("ppermute", "workers",
                               self._on_bits("ppermute", permute), x)

    def broadcast_from_root(self, x: torch.Tensor,
                            root: int = 0) -> torch.Tensor:
        """Worker ``root``'s ``x`` on every worker, bit for bit: the
        reference's integer psum of ``where(root, bits, 0)``
        (``repro.core.parallel._root_broadcast``)."""
        def bcast(bits):
            out = bits.clone()
            dist.broadcast(out, self.w_ranks[root], group=self.w_group)
            return out

        return collective_call("broadcast", "workers",
                               self._on_bits("broadcast", bcast), x)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of an integer ``x`` over the workers group."""
        if x.is_floating_point():
            raise TypeError("psum sums integers only")

        def reduce(bits):
            out = bits.clone()
            dist.all_reduce(out, group=self.w_group)
            return out

        return collective_call("psum", "workers",
                               self._on_bits("psum", reduce), x)

    # -- outside the program ------------------------------------------------

    def assemble_queries(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The whole batch from the query shards: ``x`` of every rank of
        the queries group, concatenated along ``dim``.  The counterpart
        of reading (or resharding) the reference's ``P(q_axis)`` output:
        the census reports it apart from the program's collectives."""
        if self.queries == 1:
            return x
        return collective_call("assemble", "queries",
                               self._gather(self.q_axis, dim), x,
                               counted=False)

    def max_over_mesh(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of a host tensor over the whole mesh,
        so that every rank takes the same measured choice (calibration);
        not a collective of any program."""
        out = x.detach().to(torch.float64)
        if self.size > 1:
            # NCCL reduces device tensors only
            out = out.to(self.device if self.backend == "nccl" else "cpu")
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.all_group)
        return out.to("cpu")


def _make_mesh(queries: int, workers: int, device, q_axis: str,
               w_axis: str, timeout: float) -> WorkerMesh:
    dev = _ensure_world(device)
    key = (queries, workers, dev.type, q_axis, w_axis, float(timeout))
    if key in _MESHES:
        return _MESHES[key]
    rank = dist.get_rank()
    backend = dist.get_backend()
    tmo = _timeout(timeout)
    # every rank makes every group, members or not (torch.distributed's
    # rule), in the same order
    w_groups = [tuple(qi * workers + wi for wi in range(workers))
                for qi in range(queries)]
    q_groups = [tuple(qi * workers + wi for qi in range(queries))
                for wi in range(workers)]
    made = {}
    for ranks in w_groups + q_groups + [tuple(range(queries * workers))]:
        if ranks not in made:
            made[ranks] = dist.new_group(list(ranks), timeout=tmo,
                                         backend=backend)
    inside = rank < queries * workers
    qi, wi = divmod(rank, workers) if inside else (None, None)
    staged = (SHARED_CARD_STAGED if dev.type == "cuda" and backend == "gloo"
              else frozenset())
    mesh = WorkerMesh(
        device=dev, backend=backend, rank=rank,
        queries=queries, workers=workers, q_index=qi, w_index=wi,
        w_group=made[w_groups[qi]] if inside else None,
        q_group=made[q_groups[wi]] if inside else None,
        w_ranks=w_groups[qi] if inside else (),
        q_ranks=q_groups[wi] if inside else (), staged=staged,
        q_axis=q_axis, w_axis=w_axis, timeout=timeout,
        all_group=made[tuple(range(queries * workers))] if inside else None)
    _MESHES[key] = mesh
    return mesh


def make_worker_mesh(n: int | None = None, *, device=None,
                     timeout: float = TIMEOUT_S) -> WorkerMesh:
    """Flat 1-D mesh of ``n`` workers (default: the whole world) over
    the first n ranks.  Joins a world of one when there is none."""
    _ensure_world(device)
    world = dist.get_world_size()
    if not 1 <= (n or world) <= world:
        raise ValueError(f"a mesh of {n} workers needs {n} ranks, the "
                         f"world has {world}")
    return _make_mesh(1, n or world, device, "queries", "workers", timeout)


def engine_mesh_shape(p: int, n_devices: int | None = None,
                      ) -> tuple[int, int]:
    """(queries, workers) factoring of the rank count for a partition
    count ``p``: workers is the largest power of two that divides both
    the rank count and p (the program requires p % workers == 0), and
    queries absorbs the rest.  Pure Python, the reference's function."""
    ndev = n_devices or world_size()
    workers = 1
    while (workers * 2 <= ndev and p % (workers * 2) == 0
           and ndev % (workers * 2) == 0):
        workers *= 2
    return ndev // workers, workers


def make_engine_mesh(queries: int | None = None,
                     workers: int | None = None, *, device=None,
                     q_axis: str = "queries", w_axis: str = "workers",
                     timeout: float = TIMEOUT_S) -> WorkerMesh:
    """2-D (queries x workers) mesh for `SkylineEngine`'s sharded path,
    with the reference's rules: both sizes omitted put every rank on the
    workers axis; one omitted is derived (it must divide the rank
    count); the product may be below the rank count (a prefix of the
    ranks is used)."""
    _ensure_world(device)
    ndev = dist.get_world_size()
    if queries is None and workers is None:
        queries, workers = 1, ndev
    elif queries is None:
        if ndev % workers:
            raise ValueError(f"workers={workers} must divide the device "
                             f"count {ndev} when queries is derived")
        queries = ndev // workers
    elif workers is None:
        if ndev % queries:
            raise ValueError(f"queries={queries} must divide the device "
                             f"count {ndev} when workers is derived")
        workers = ndev // queries
    if queries < 1 or workers < 1 or queries * workers > ndev:
        raise ValueError(
            f"engine mesh ({queries} x {workers}) needs "
            f"{queries * workers} devices, have {ndev}")
    return _make_mesh(queries, workers, device, q_axis, w_axis, timeout)
