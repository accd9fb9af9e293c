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

The model side's meshes.  The language models shard over
``torch.distributed.tensor`` (DTensor): `make_local_mesh` and
`make_production_mesh` return a ``DeviceMesh`` with the reference's axis
names, (data, model) or (pod, data, model), over the current world
(joined as a world of one when there is none; the world's size must be
the mesh's).  `set_mesh` makes a mesh the current one, as the
reference's ``set_mesh``.  This module re-exports what the sharding layer
needs (``DeviceMesh``, ``DTensor``, the placements ``Shard``,
``Replicate`` and ``Partial``, ``distribute_tensor``,
``implicit_replication``), so that no other module imports
``torch.distributed``; its `local_map` is torch's, save that a body's
output keeps an uneven shard's global shape.  `fake_world` is a world
of N ranks in this one process over the ``fake`` backend: the dry run's
stand-in for the reference's forced host devices.  Its collectives move
nothing; with local shards on the meta device nothing is allocated
either.

Ranks that share one card run gloo, and DTensor's redistributions call
the groups' collectives on CUDA tensors through ``torch.distributed``'s
functional collectives: ``all_gather_into_tensor`` (Shard to
Replicate), ``all_reduce`` (Partial to Replicate),
``reduce_scatter_tensor`` (Partial to Shard) and ``all_to_all_single``
(Shard(i) to Shard(j)).  Gloo takes CUDA tensors for all of them but
the functional all-gather, which crashed the process on the card (a
segfault, torch 2.11).  So a world whose ranks share a card is made
with the ``cardgloo`` backend for CUDA tensors (`CardGloo`): gloo
itself, with the kinds of `SHARED_CARD_DTENSOR` staged through pinned
host memory.  As with `SHARED_CARD_STAGED`, this is fixed when the
world is made, never reached by catching an error.

Why two stagings: DTensor calls the all-gather inside torch, so only
the process group can stage it.  The ppermute's send and receive stay
staged in `WorkerMesh`, around ``dist.send`` / ``dist.recv``: a staged
receive inside `CardGloo` would have to wait on gloo's work itself
before its copy back (gloo's point-to-point works have no future to
chain the copy onto), and under skylint's bare-name call graph that
``wait`` would make every function named ``wait`` in the port
pipeline-reachable (rule R1 then flags the serving engine's
``_WaveRecord.wait``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
from torch._C._distributed_c10d import (AllgatherOptions,
                                        AllreduceCoalescedOptions,
                                        AllreduceOptions, AllToAllOptions,
                                        BarrierOptions, BroadcastOptions,
                                        ReduceScatterOptions,
                                        _create_work_from_future)
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed._functional_collectives import AsyncCollectiveTensor
from torch.distributed.tensor.experimental import (
    implicit_replication as _implicit_replication)

from repro_torch.kernels.backend import collective_call, resolve_device

__all__ = ["WorkerMesh", "World", "init_world", "close_world", "world_size",
           "file_store", "run_world", "make_worker_mesh", "make_engine_mesh",
           "engine_mesh_shape", "TIMEOUT_S", "SHARED_CARD_STAGED",
           "make_local_mesh", "make_production_mesh", "set_mesh",
           "current_mesh", "fake_world", "has_fake_backend",
           "DeviceMesh", "CardGloo", "SHARED_CARD_BACKEND",
           "DTensor", "Shard", "Replicate", "Partial", "distribute_tensor",
           "local_map", "implicit_replication", "SHARED_CARD_DTENSOR"]

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


def _done_work(value=None):
    fut = torch.futures.Future()
    fut.set_result(value)
    return _create_work_from_future(fut)


class CardGloo(dist.ProcessGroup):
    """Gloo for ranks that share one card: each collective runs on a
    gloo backend of the group, with the CUDA tensors as they are, except
    the kinds of `SHARED_CARD_DTENSOR`, which go through pinned host
    memory (copied out, run on the host, copied back)."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)
        # the group's name and options live on its backends
        for dev in ("cpu", "cuda"):
            self._register_backend(torch.device(dev),
                                   dist.ProcessGroup.BackendType.GLOO,
                                   self._gloo)

    def getBackendName(self) -> str:
        return "cardgloo"

    def _staged_gather(self, output, input, opts):
        if not input.is_cuda:
            return self._gloo._allgather_base(output, input, opts)
        host_in = torch.empty(input.shape, dtype=input.dtype,
                              pin_memory=True)
        host_out = torch.empty(output.shape, dtype=output.dtype,
                               pin_memory=True)
        host_in.copy_(input)
        self._gloo._allgather_base(host_out, host_in, opts).wait()
        output.copy_(host_out)
        return _done_work(output)

    def _allgather_base(self, output, input, opts=AllgatherOptions()):
        return self._staged_gather(output, input, opts)

    def allgather_into_tensor_coalesced(self, outputs, inputs,
                                        opts=AllgatherOptions()):
        for o, i in zip(outputs, inputs):
            self._staged_gather(o, i, opts).wait()
        return _done_work(outputs)

    def allgather(self, outputs, inputs, opts=AllgatherOptions()):
        return self._gloo.allgather(outputs, inputs, opts)

    def allreduce(self, tensors, opts=AllreduceOptions()):
        return self._gloo.allreduce(tensors, opts)

    def allreduce_coalesced(self, tensors, opts=AllreduceCoalescedOptions()):
        return self._gloo.allreduce_coalesced(tensors, opts)

    def _reduce_scatter_base(self, output, input,
                             opts=ReduceScatterOptions()):
        return self._gloo._reduce_scatter_base(output, input, opts)

    def reduce_scatter_tensor_coalesced(self, outputs, inputs,
                                        opts=ReduceScatterOptions()):
        for o, i in zip(outputs, inputs):
            self._gloo._reduce_scatter_base(o, i, opts).wait()
        return _done_work(outputs)

    def alltoall_base(self, output, input, output_splits, input_splits,
                      opts=AllToAllOptions()):
        return self._gloo.alltoall_base(output, input, output_splits,
                                        input_splits, opts)

    def broadcast(self, tensors, opts=BroadcastOptions()):
        return self._gloo.broadcast(tensors, opts)

    def barrier(self, opts=BarrierOptions()):
        return self._gloo.barrier(opts)

    def send(self, tensors, dst: int, tag: int = 0):
        return self._gloo.send(tensors, dst, tag)

    def recv(self, tensors, src: int, tag: int = 0):
        return self._gloo.recv(tensors, src, tag)


dist.Backend.register_backend("cardgloo", CardGloo, devices=["cpu", "cuda"])

# the backend of a world whose ranks share the card: cardgloo for CUDA
# tensors, gloo for host tensors
SHARED_CARD_BACKEND = "cpu:gloo,cuda:cardgloo"


def init_world(rank: int, size: int, *, store=None, init_method=None,
               device=None, timeout: float = TIMEOUT_S) -> torch.device:
    """Join a world of ``size`` ranks as ``rank``; returns this rank's
    device.

    The rendezvous is ``store`` (a ``torch.distributed`` store, such as
    ``FileStore(path, size)``) or ``init_method`` (``"tcp://localhost:
    <port>"``); a world of one needs neither.  On the card (``device``
    None or ``"cuda"``) rank r takes card ``r % count``, and the backend
    is NCCL when every rank has its own card, else gloo (ranks share
    cards: `SHARED_CARD_BACKEND`, gloo with `CardGloo` for CUDA
    tensors).  ``device="cpu"`` takes gloo."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", rank % cards)
        torch.cuda.set_device(dev)
        backend = "nccl" if size <= cards else SHARED_CARD_BACKEND
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
    _DEVICE_MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """Ranks in the world (1 outside one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


class World:
    """``size`` spawned ranks joined into one world through the file
    store at ``store`` (on ``device``, which the caller names: None or
    ``"cuda"`` the card, ``"cpu"`` the host, see `init_world`; each
    collective waits ``timeout`` seconds), kept until `close`.
    ``run(fn, *args)`` calls ``fn(*args)`` in every rank (``fn`` a
    module-level function, its arguments and result picklable) and
    returns the results in rank order; it raises ``RuntimeError`` with
    the tracebacks when a rank fails, and kills the world when a rank
    does not answer within ``deadline`` seconds."""

    def __init__(self, size: int, store: str, *, device,
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


def run_world(fn, size: int, *args, device, deadline: float,
              timeout: float = TIMEOUT_S) -> list:
    """``fn(*args)`` in every rank of a `World` of ``size`` on ``device``
    (named by the caller, as `World`'s) made for this one run (its store
    in a temporary directory, removed after); each rank's result, in
    rank order."""
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
    config = dist.get_backend()
    backend = "nccl" if config == "nccl" else "gloo"
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
                                         backend=config)
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


# --------------------------------------------------------------------------
# The model side's meshes (DTensor)
# --------------------------------------------------------------------------

# the tensor collectives `CardGloo` stages through pinned host memory
# (the rest run on gloo with the CUDA tensors; held by chip_smoke.py's
# step S)
SHARED_CARD_DTENSOR = frozenset({"all_gather_into_tensor"})

_DEVICE_MESHES: dict[tuple, DeviceMesh] = {}
_CURRENT: list[DeviceMesh] = []
_IMPLICIT = [0]


@contextlib.contextmanager
def implicit_replication():
    """Within the block DTensor takes plain tensors as replicated
    (torch's ``implicit_replication``, made reentrant: torch's own
    switches it off when an inner block ends)."""
    if _IMPLICIT[0]:
        yield
        return
    _IMPLICIT[0] += 1
    try:
        with _implicit_replication():
            yield
    finally:
        _IMPLICIT[0] -= 1


def local_map(func, out_placements, in_placements=None,
              in_grad_placements=None, device_mesh=None,
              redistribute_inputs: bool = False, out_shapes=None):
    """torch's ``local_map`` for positional arguments (``out_placements``
    a tuple of placements per output, or a list of placements for a
    single output), save that an output's global shape follows the
    inputs: a dim sharded over the same mesh dims as a dim of a DTensor
    input, with the same local size, takes that dim's global size
    (``out_shapes``, one global shape or None per output, says it
    outright).  So an uneven shard keeps its true global shape (a
    microbatch of 8 rows over 16 data ranks: ranks 0-7 hold a row each,
    the rest none, as GSPMD pads it), where torch's ``from_local``
    without a shape takes the local size times the mesh dims' size."""
    def run(*args):
        mesh, local, inputs = device_mesh, [], []
        for i, a in enumerate(args):
            if not isinstance(a, DTensor):
                local.append(a)
                continue
            mesh = mesh or a.device_mesh
            grad = None
            if in_placements is not None:
                want = tuple(in_placements[i])
                if tuple(a.placements) != want:
                    if not redistribute_inputs:
                        raise ValueError(f"argument {i} is placed "
                                         f"{a.placements}, not {want}")
                    a = a.redistribute(mesh, want)
            if in_grad_placements is not None:
                grad = tuple(in_grad_placements[i])
            part = a.to_local(grad_placements=grad)
            if isinstance(part, AsyncCollectiveTensor):
                part = part.trigger_wait()
            local.append(part)
            inputs.append((a, part.shape))
        out = func(*local)
        if not inputs:
            return out
        single = not isinstance(out_placements, tuple)
        outs, pls = ((out,), (out_placements,)) if single else (
            out, out_placements)
        if len(outs) != len(pls):
            raise ValueError(f"{len(outs)} outputs, {len(pls)} placements")
        shapes = out_shapes or (None,) * len(outs)
        made = tuple(_from_local(o, mesh, tuple(p), inputs, shape)
                     if isinstance(o, torch.Tensor) else o
                     for o, p, shape in zip(outs, pls, shapes))
        return made[0] if single else made

    return run


def _sharded_dims(placements, dim: int) -> list:
    return [i for i, p in enumerate(placements) if p.is_shard(dim)]


def _from_local(part, mesh, placements, inputs, given=None) -> DTensor:
    """``part`` as a DTensor; its global shape ``given``, or by
    `local_map`'s rule."""
    shape = list(part.shape if given is None else given)
    for d in range(part.ndim if given is None else 0):
        dims = _sharded_dims(placements, d)
        if dims:
            shape[d] = next(
                (t.shape[e] for t, lshape in inputs for e in range(t.ndim)
                 if lshape[e] == part.shape[d]
                 and _sharded_dims(t.placements, e) == dims),
                part.shape[d] * math.prod(mesh.size(i) for i in dims))
    if not shape:
        return DTensor.from_local(part, mesh, placements, run_check=False)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * max(shape[d + 1], 1)
    return DTensor.from_local(part, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _device_mesh(shape: tuple, names: tuple, device) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``names`` over the whole
    world (one made per shape and device type, kept until
    `close_world`)."""
    dev = _ensure_world(device)
    size = dist.get_world_size()
    if size != math.prod(shape):
        raise ValueError(f"a {' x '.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks, the world has {size}")
    key = (shape, names, dev.type)
    if key not in _DEVICE_MESHES:
        _DEVICE_MESHES[key] = init_device_mesh(dev.type, shape,
                                               mesh_dim_names=names)
    return _DEVICE_MESHES[key]


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device=None) -> DeviceMesh:
    """A (data, model) mesh over a world of ``data * model`` ranks (a
    world of one is joined when there is none)."""
    return _device_mesh((data, model), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The reference's production meshes: (16, 16) data x model = 256
    ranks, or with ``multi_pod`` (2, 16, 16) pod x data x model = 512.
    On a `fake_world` of that size for the dry run."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, names, device)


@contextlib.contextmanager
def set_mesh(mesh: DeviceMesh):
    """Make ``mesh`` the current mesh within the block (`current_mesh`),
    as the reference's ``set_mesh``: an enabled ``Sharder`` and the
    sharded train step place plain tensors on it."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh() -> DeviceMesh | None:
    return _CURRENT[-1] if _CURRENT else None


def has_fake_backend() -> bool:
    """Whether this torch has the ``fake`` process-group backend."""
    try:
        from torch.testing._internal.distributed.fake_pg import (  # noqa: F401
            FakeStore)
    except ImportError:
        return False
    return True


@contextlib.contextmanager
def fake_world(size: int):
    """This process as rank 0 of a world of ``size`` ranks over the
    ``fake`` backend (``torch.testing._internal.distributed.fake_pg``):
    groups and DTensor redistributions work and are counted, nothing
    travels.  The world is left at the end of the block.  Raises
    ``RuntimeError`` when this torch lacks the backend or a world is
    already joined."""
    if not has_fake_backend():
        raise RuntimeError("this torch has no fake process-group backend "
                           "(torch.testing._internal.distributed.fake_pg)")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a world is already joined; the fake world "
                           "needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        close_world()
