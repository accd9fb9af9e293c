"""Layer 2: the program verifier over the dispatched operations.

Counterpart of ``repro.analysis.verifier``.  The reference traces each
cell of its program suite to a jaxpr and walks it; the port has no
tracer, so it runs each cell of `repro_torch.launch.cells` once under a
dispatch census (a ``TorchDispatchMode`` that records every aten
operation, the shapes it reads and writes, and whether it writes an
input) and asserts the same invariants on what ran:

* **no host round-trips**: no operation of `HOST_OPS` (a scalar read, a
  nonzero, a data-dependent shape) is dispatched, and on the card no
  device-to-host copy;
* **collective census**: every collective of a cell runs through the
  mesh's wrappers (`repro_torch.launch.mesh`; a raw ``c10d`` /
  ``_c10d_functional`` operation outside them fails) and over the
  workers group only; a cell without a mesh, the vmap bucket program
  ``engine_vmap`` among them, has none; the count of collectives at
  ``2q`` equals the count at ``q``.  The assembly of a query-sharded
  batch (`WorkerMesh.assemble_queries`, the counterpart of reading the
  reference's ``P(q_axis)`` output) is reported apart and not counted;
* **tree-merge boundary**: in ``merge='tree'`` cells on a mesh, exactly
  ⌈log₂ W⌉ ppermute rounds run over the workers group, and no
  collective operand or result exceeds 4·C·(d+2) elements (C the state
  capacity): O(capacity), never the flat merge's p x C_loc union;
* **Q-independence**: for ``batch``, ``stream``, ``window`` and
  ``slab_wave`` the count of dispatched operations at ``2q`` equals the
  count at ``q``: Q queries take the operations of one;
* **slab boundary shapes**: for ``slab_feed`` and ``slab_wave`` (epoch
  capacity below the state capacity C) no operation that reads or
  writes an arena leaf, and no input or output of the wave, carries C;
* **in-place state updates**: for the state-bearing cells (built with
  ``SkyConfig.donate`` on, the default), every state or arena leaf of
  at least 1 KiB keeps its storage across the call and the census shows
  a write to it (the counterpart of ``input_output_alias``): a cell
  built with donation off fails here;
* **shared-memory cap**: the kernels' footprint laws
  (`repro_torch.kernels.backend.smem_estimate`) stay under the per-CTA
  cap at the cell's configuration.

A kernel-family call is one operation of the census, as the kernel is
one launch on the card: the family's entry hands it to the census
(`repro_torch.kernels.backend.kernel_call`), which does not count the
operations inside; so is a collective
(`repro_torch.kernels.backend.collective_call`), counted by kind and
group with the elements of its operand and result.  In a world of
several ranks every rank runs every cell it is a member of (a mesh may
take a prefix of the ranks), and each rank's census is checked.  On the CPU those are the plain version's, which
bounds its loops from the data on the host by design; they are counted
apart (``plain_host_ops``) and gate nothing.

On the card each cell also runs under ``set_sync_debug_mode("error")``,
is captured into a CUDA graph at ``q`` and at ``2q`` (equal kernel-node
counts; a capture fails on any host sync), and its peak device memory
less its inputs stays under ``mem_cap``.  On the CPU the memory is
recorded as not measured.
"""

from __future__ import annotations

import collections
import ctypes
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["verify_programs", "verify_world", "Census", "graph_ops",
           "no_sync", "host_op_probe",
           "HOST_OPS", "DEFAULT_SMEM_CAP", "DEFAULT_MEM_CAP"]

# the sm_90 per-CTA shared-memory opt-in (kernels/sfs/kernel.py:48)
DEFAULT_SMEM_CAP = 232_448
# per-cell peak device memory of one call, less its inputs: the cells
# are smoke-sized, so 64 MiB (the reference's budget) catches an order-
# of-magnitude regression (an A/B copy of a state, a temporary blow-up)
DEFAULT_MEM_CAP = 64 * 2 ** 20

# aten operations that read device data on the host (the answer's value
# or a data-dependent output shape): each one is a sync on the card
HOST_OPS = frozenset({
    "aten::_local_scalar_dense", "aten::item", "aten::is_nonzero",
    "aten::equal", "aten::nonzero", "aten::nonzero_numpy",
    "aten::argwhere", "aten::masked_select", "aten::_unique",
    "aten::_unique2", "aten::unique_dim", "aten::unique_consecutive",
    "aten::unique_dim_consecutive",
})
# ... and these, in the cases that have a data-dependent output shape
_REPEAT_INTERLEAVE = "aten::repeat_interleave"
_BOOL_INDEX_OPS = frozenset({"aten::index", "aten::index_put",
                             "aten::index_put_", "aten::_index_put_impl_"})
_COPY_OPS = frozenset({"aten::_to_copy", "aten::copy_"})
_COLLECTIVE_NAMESPACES = ("c10d::", "_c10d_functional::",
                          "c10d_functional::")
# cells whose state (or arena) the program writes in place
_DONATED_KINDS = {"stream", "window", "wtick", "slab_feed", "slab_wave"}
_Q_KINDS = {"batch", "stream", "window", "slab_wave"}
# leaves below this size (the counters) need not be checked: the
# invariant is about the memory-bearing buffers (points, mask)
_ALIAS_MIN_BYTES = 1024


def _tensors(tree):
    """Every tensor in a nest of tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _host_op(func, args, kwargs) -> str | None:
    """The name under which this dispatched operation reads the device
    from the host, or None."""
    name = func._schema.name
    if name in HOST_OPS:
        return name
    if name == _REPEAT_INTERLEAVE and func._overloadname.startswith(
            "Tensor") and kwargs.get("output_size") is None \
            and (len(args) < 3 or args[2] is None):
        return f"{name} without output_size"
    if name in _BOOL_INDEX_OPS and len(args) > 1 and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in args[1] or ()):
        return f"{name} with a boolean index"
    if name in _COPY_OPS:
        if name == "aten::copy_":
            src, dst = args[1], args[0].device
            blocking = not (args[2] if len(args) > 2
                            else kwargs.get("non_blocking", False))
        else:
            src = args[0]
            dst = torch.device(kwargs.get("device") or src.device)
            blocking = not kwargs.get("non_blocking", False)
        if src.device.type != "cpu" and dst.type == "cpu" and blocking:
            return f"{name} from the device to the host"
        if src.device.type == "cpu" and dst.type != "cpu" \
                and not src.is_pinned():
            return f"{name} from pageable host memory to the device"
    return None


class Census(TorchDispatchMode):
    """Records every dispatched aten operation of one program run.

    ``watch`` maps storage pointers to leaf labels: for each watched
    leaf the census records whether an operation wrote it and the shapes
    of every operation that read or wrote it."""

    def __init__(self, watch: dict[int, str] | None = None):
        super().__init__()
        self.watch = watch or {}
        self.ops = 0
        self.by_op: collections.Counter = collections.Counter()
        self.kernels: collections.Counter = collections.Counter()
        self.host_ops: list[str] = []
        self.plain_host_ops: collections.Counter = collections.Counter()
        self.collectives: collections.Counter = collections.Counter()
        self.raw_collectives: collections.Counter = collections.Counter()
        self.assembled: collections.Counter = collections.Counter()
        self.collective_elems = 0
        self.written: set[int] = set()
        self.touch_dims: set[int] = set()
        self._inside = None   # the kernel implementation running

    def record_kernel(self, family, impl, fn, args, kwargs):
        """One kernel-family call: one operation of the program (see
        `repro_torch.kernels.backend.kernel_call`)."""
        self.ops += 1
        self.kernels[family] += 1
        self._inside = impl
        try:
            out = fn(*args, **kwargs)
        finally:
            self._inside = None
        self._note_watched((args, kwargs), out, ())
        return out

    def record_collective(self, kind, group, fn, x, counted):
        """One collective of the mesh (see
        `repro_torch.kernels.backend.collective_call`): one operation of
        the program by (kind, group), or, not ``counted``, the assembly
        of a sharded batch, reported apart."""
        self._inside = "collective"
        try:
            out = fn(x)
        finally:
            self._inside = None
        if counted:
            self.ops += 1
            self.collectives[(kind, group)] += 1
            self.collective_elems = max(self.collective_elems, x.numel(),
                                        out.numel())
        else:
            self.assembled[(kind, group)] += 1
        return out

    def _note_watched(self, inputs, outputs, written) -> None:
        if not self.watch:
            return
        ins = list(_tensors(inputs))
        outs = list(_tensors(outputs))
        hit = {p for p in map(_storage, ins + outs) if p in self.watch}
        if hit:
            for t in ins + outs:
                self.touch_dims.update(int(s) for s in t.shape)
            self.written.update(p for p in written if p in self.watch)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        host = _host_op(func, args, kwargs)
        if self._inside is not None:
            if host:
                if self._inside == "cuda":   # the kernel's own wrapper
                    self.host_ops.append(f"{host} (in the CUDA wrapper)")
                elif self._inside == "collective":
                    self.host_ops.append(f"{host} (in a collective)")
                else:
                    self.plain_host_ops[host] += 1
            return out
        name = func._schema.name
        self.ops += 1
        self.by_op[name] += 1
        if host:
            self.host_ops.append(host)
        if name.startswith(_COLLECTIVE_NAMESPACES):
            self.raw_collectives[name] += 1
        written = []
        for arg, val in zip(func._schema.arguments, args):
            if arg.alias_info is not None and arg.alias_info.is_write:
                written.extend(_storage(t) for t in _tensors(val))
        for arg in func._schema.arguments:
            if arg.name in kwargs and arg.alias_info is not None \
                    and arg.alias_info.is_write:
                written.extend(_storage(t) for t in _tensors(
                    kwargs[arg.name]))
        self._note_watched((args, kwargs), out, written)
        return out


def _census(built, watch=None) -> tuple[Census, object]:
    """Run ``built`` once under a census; returns (census, outputs)."""
    with Census(watch) as census:
        out = built.fn(*built.args)
    return census, out


# --------------------------------------------------------------------------
# the card: host-sync probe, CUDA graph census
# --------------------------------------------------------------------------

def no_sync(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: a
    host synchronisation inside raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


_GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                     4: "graph", 5: "empty", 6: "wait", 7: "record",
                     10: "alloc", 11: "free"}


def graph_ops(fn) -> dict:
    """The device operations of one call of ``fn``, counted the same way
    every time: after a warm-up on a side stream, the call is captured
    into a CUDA graph, and libcuda lists the graph's nodes
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``).  Returns the count of
    each node type.  A host sync inside ``fn`` fails the capture."""
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    counts: dict[str, int] = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                 ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        name = _GRAPH_NODE_TYPES.get(kind.value, f"type{kind.value}")
        counts[name] = counts.get(name, 0) + 1
    graph.reset()
    torch.cuda.synchronize()
    return dict(sorted(counts.items()))


def host_op_probe(device) -> dict[str, bool]:
    """For each case of `HOST_OPS` and the conditional host operations,
    whether one tiny call raises under ``set_sync_debug_mode("error")``
    on ``device`` (a card): where the two lists differ, this says so."""
    x = torch.arange(8, dtype=torch.float32, device=device)
    m = x > 3
    cases = {
        "aten::_local_scalar_dense": lambda: x[0].item(),
        "aten::is_nonzero": lambda: bool(x[0]),
        "aten::equal": lambda: torch.equal(x, x),
        "aten::nonzero": lambda: torch.nonzero(m),
        "aten::argwhere": lambda: torch.argwhere(m),
        "aten::masked_select": lambda: torch.masked_select(x, m),
        "aten::_unique2": lambda: torch.unique(x),
        "aten::unique_consecutive": lambda: torch.unique_consecutive(x),
        "aten::unique_dim": lambda: torch.unique(x[None], dim=1),
        "aten::repeat_interleave without output_size":
            lambda: torch.repeat_interleave(m.long()),
        "aten::index with a boolean index": lambda: x[m],
        "aten::index_put_ with a boolean index":
            lambda: x.clone().index_put_((m,), x[:1].clone()),
        "aten::copy_ from the device to the host": lambda: x.cpu(),
        # not a host op: the same calls with the shape given
        "repeat_interleave with output_size (none expected)":
            lambda: torch.repeat_interleave(m.long(), output_size=4),
        "torch.where on a mask (none expected)":
            lambda: torch.where(m, x, 0.0),
    }
    out = {}
    for name, call in cases.items():
        try:
            no_sync(call)
            out[name] = False
        except RuntimeError:
            out[name] = True
    torch.cuda.synchronize()
    return out


# --------------------------------------------------------------------------
# the verification pass
# --------------------------------------------------------------------------

def _dims(tree) -> set[int]:
    return {int(s) for t in _tensors(tree) for s in t.shape}


def _build(name, spec, *, device, meshed, q=None):
    from repro_torch.launch.cells import SKYLINE_CELLS, build_skyline_cell
    if q is not None:
        spec = dict(spec, q=q)
    return build_skyline_cell(name, spec, smoke=name in SKYLINE_CELLS,
                              device=device, meshed=meshed)


def _check_cell(name, spec, *, device, smem_cap, mem_cap, meshed, errors,
                record) -> None:
    from repro_torch.core.incremental import state_capacity
    from repro_torch.kernels.backend import smem_estimate

    from repro_torch.core.parallel import merge_rounds

    on_card = device.type == "cuda"
    built = _build(name, spec, device=device, meshed=meshed)
    record.update(kind=built.kind, mesh=built.info["mesh"],
                  axes={k: built.info[k] for k in ("workers", "queries")
                        if k in built.info})
    if built.fn is None:
        record["skipped"] = (f"rank {built.mesh.rank} is outside the "
                             f"cell's {built.mesh.queries} x "
                             f"{built.mesh.workers} mesh")
        return
    # the leaves written in place, watched by storage
    watch = {_storage(t): f"leaf{i}" for i, t in enumerate(built.state)}
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        census, out = no_sync(lambda: _census(built, watch))
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated(device) - base
        inputs = sum(t.numel() * t.element_size()
                     for t in _tensors(built.args))
        record["memory"] = {"measured": True, "call_bytes": extra,
                            "input_bytes": inputs,
                            "peak_bytes": extra + inputs}
        if extra > mem_cap:
            errors.append(f"{name}: one call takes {extra} B of device "
                          f"memory beyond its inputs, above the "
                          f"{mem_cap} B per-cell budget")
    else:
        census, out = _census(built, watch)
        record["memory"] = {"measured": False,
                            "note": "not measured: device memory is read "
                                    "on the card only"}
    coll = {f"{k}@{g}": n for (k, g), n in census.collectives.items()}
    record.update(ops=census.ops, kernels=dict(census.kernels),
                  host_ops=census.host_ops,
                  plain_host_ops=dict(census.plain_host_ops),
                  collectives=coll,
                  assembled={f"{k}@{g}": n
                             for (k, g), n in census.assembled.items()})
    if census.host_ops:
        errors.append(f"{name}: host round-trips dispatched: "
                      f"{sorted(set(census.host_ops))}")
    if census.raw_collectives:
        errors.append(f"{name}: collectives dispatched outside the mesh's "
                      f"wrappers: {dict(census.raw_collectives)}")
    groups = {g for _, g in census.collectives}
    if groups - {"workers"}:
        errors.append(f"{name}: collectives over non-worker groups "
                      f"{sorted(groups - {'workers'})}: merges must stay "
                      f"on the workers group")
    if built.kind == "vmap_batch" and census.collectives:
        errors.append(f"{name}: the vmap bucket program must be "
                      f"collective-free, found {coll}")
    elif built.mesh is None and census.collectives:
        errors.append(f"{name}: collectives dispatched without a mesh: "
                      f"{coll}")

    if built.cfg.merge == "tree" and built.mesh is not None:
        w = built.mesh.workers
        rounds = merge_rounds(w)
        nperm = census.collectives.get(("ppermute", "workers"), 0)
        record["tree_rounds"] = {"expected": rounds, "ppermute": nperm}
        if nperm != rounds:
            errors.append(
                f"{name}: tree merge must run exactly ceil(log2({w})) = "
                f"{rounds} ppermute rounds over workers, found {nperm}")
        bound = 4 * state_capacity(built.cfg) * (built.info["d"] + 2)
        worst = census.collective_elems
        record["tree_boundary"] = {"bound": bound, "max_operand": worst}
        if worst > bound:
            errors.append(
                f"{name}: a workers collective carries {worst} elements, "
                f"above the tree-merge boundary bound {bound} (O(capacity)"
                f", independent of p): the flat union must never ride a "
                f"tree-mode program")

    if built.kind in ("slab_feed", "slab_wave"):
        c = state_capacity(built.cfg)
        dims = census.touch_dims | _dims(built.args) | _dims(out)
        record["boundary_dims"] = sorted(dims)
        if built.info["epoch_cap"] < c and c in dims:
            errors.append(
                f"{name}: full state capacity C={c} crosses the slab "
                f"{'wave' if built.kind == 'slab_wave' else 'feed'} "
                f"boundary (the arena's gather/scatter or the wave's "
                f"inputs and outputs): slots must stay at their "
                f"rows/epoch_capacity shapes")

    if built.kind in _DONATED_KINDS:
        record["donate"] = built.cfg.donate
        after = built.updated(out)
        leaves = {}
        for i, (old, new) in enumerate(zip(built.state, after)):
            if old.numel() * old.element_size() < _ALIAS_MIN_BYTES:
                continue
            ptr = _storage(old)
            kept = _storage(new) == ptr
            written = ptr in census.written
            leaves[f"leaf{i}"] = {"kept": kept, "written": written}
            if not (kept and written):
                errors.append(
                    f"{name}: state leaf {i} {tuple(old.shape)} was not "
                    f"updated in place (storage kept: {kept}, written by "
                    f"the program: {written}): the update is an A/B copy")
        record["inplace"] = leaves

    if built.kind in _Q_KINDS:
        q2 = spec["q"] * 2
        built2 = _build(name, spec, device=device, meshed=meshed, q=q2)
        census2, _ = (no_sync(lambda: _census(built2)) if on_card
                      else _census(built2))
        record["op_count_q"] = census.ops
        record["op_count_2q"] = census2.ops
        n1 = sum(census.collectives.values())
        n2 = sum(census2.collectives.values())
        record["collective_count_q"] = n1
        record["collective_count_2q"] = n2
        if n1 != n2:
            errors.append(f"{name}: collective count changed {n1} -> {n2} "
                          f"when Q doubled: merge communication must be "
                          f"Q-independent")
        if census.ops != census2.ops:
            grew = {k: census2.by_op[k] - census.by_op.get(k, 0)
                    for k in census2.by_op
                    if census2.by_op[k] != census.by_op.get(k, 0)}
            errors.append(f"{name}: dispatched operations changed "
                          f"{census.ops} -> {census2.ops} when Q doubled "
                          f"({grew}): Q queries must take the operations "
                          f"of one")

    est = smem_estimate(built.info["d"], built.cfg.block,
                        built.info["wcap"])
    record["smem"] = est
    for fam in ("sweep", "dominance"):
        if est[fam] > smem_cap:
            errors.append(
                f"{name}: {fam} kernel shared-memory law {est[fam]} B "
                f"exceeds the {smem_cap} B per-CTA cap at d="
                f"{built.info['d']}, block={built.cfg.block}, "
                f"wcap={built.info['wcap']}")

    if on_card:
        graph = {"q": graph_ops(lambda: built.fn(*built.args))}
        if "q" in spec:
            b2 = _build(name, spec, device=device, meshed=meshed,
                        q=spec["q"] * 2)
            graph["2q"] = graph_ops(lambda: b2.fn(*b2.args))
            k1 = graph["q"].get("kernel", 0)
            k2 = graph["2q"].get("kernel", 0)
            if k1 != k2:
                errors.append(f"{name}: CUDA graph kernel nodes changed "
                              f"{k1} -> {k2} when Q doubled")
        record["graph"] = graph


def verify_programs(names=None, *, device=None,
                    smem_cap: int = DEFAULT_SMEM_CAP,
                    mem_cap: int = DEFAULT_MEM_CAP, meshed: bool = False):
    """Verify the program suite; returns ``(report: dict, errors:
    list[str])``: empty ``errors`` means every invariant holds.

    Runs on the card unless ``device="cpu"`` (without CUDA that raises
    ``RuntimeError``).  ``names`` restricts the suite.  Dry-run cells
    build in smoke size, verifier-only cells at their declared sizes.  A
    cell that fails to build or to run is an error.  In a world of one
    the cells run without a mesh (the one-device programs); ``meshed``
    runs them on 1 x 1 meshes instead (`repro_torch.launch.cells`)."""
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.launch.cells import SKYLINE_CELLS, VERIFIER_EXTRA_CELLS

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    suite = {**SKYLINE_CELLS, **VERIFIER_EXTRA_CELLS}
    if names:
        unknown = set(names) - set(suite)
        if unknown:
            raise ValueError(f"unknown cells {sorted(unknown)}; "
                             f"have {sorted(suite)}")
        suite = {k: v for k, v in suite.items() if k in names}
    from repro_torch.launch.mesh import world_size
    report: dict = {"device": str(dev), "devices": world_size(),
                    "smem_cap": smem_cap, "mem_cap": mem_cap, "cells": {}}
    if dev.type == "cuda":
        report["card"] = torch.cuda.get_device_name(dev)
    errors: list[str] = []
    for name, spec in suite.items():
        record: dict = {"kind": spec["kind"]}
        report["cells"][name] = record
        t0 = time.perf_counter()
        try:
            _check_cell(name, spec, device=dev, smem_cap=smem_cap,
                        mem_cap=mem_cap, meshed=meshed, errors=errors,
                        record=record)
        except Exception as e:  # a cell failing to build or run IS a finding
            errors.append(f"{name}: {type(e).__name__}: {e}")
            record["error"] = f"{type(e).__name__}: {e}"
        record["seconds"] = time.perf_counter() - t0
    return report, errors


def _verify_rank(names, caps):
    """One rank of `verify_world`: the suite on this rank's meshes."""
    return verify_programs(names, device="cpu", **caps)


def verify_world(names=None, *, ranks: int, smem_cap: int = DEFAULT_SMEM_CAP,
                 mem_cap: int = DEFAULT_MEM_CAP):
    """`verify_programs` on the CPU in every rank of a gloo world of
    ``ranks`` processes (`repro_torch.launch.mesh.run_world`).  Returns
    ``(report, errors)``: the report has each rank's, and every error
    names its rank.  A rank that fails, or does not report within the
    mesh's group timeout, fails the run, and the world is killed."""
    from repro_torch.launch.mesh import TIMEOUT_S, run_world

    report: dict = {"device": "cpu", "devices": ranks, "ranks": {},
                    "cells": {}}
    try:
        out = run_world(_verify_rank, ranks, names,
                        {"smem_cap": smem_cap, "mem_cap": mem_cap},
                        device="cpu", deadline=TIMEOUT_S)
    except RuntimeError as e:  # the run's failure is the report's error
        return report, [str(e)]
    errors: list[str] = []
    for rank, (rep, errs) in enumerate(out):
        report["ranks"][rank] = rep
        errors += [f"rank {rank}: {e}" for e in errs]
    report["cells"] = {name: {str(r): rep["cells"][name]
                              for r, rep in report["ranks"].items()}
                       for name in report["ranks"][0]["cells"]}
    return report, errors
