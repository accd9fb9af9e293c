"""Dry run: the model cells (arch x shape x mesh) once on a fake world
of the production mesh's size, and the skyline program cells once on a
world of ranks; record each one's memory, work and collectives.

Counterpart of ``repro.launch.dryrun``.

The model cells (without ``--skyline``).  The reference lowers and
compiles each cell's train step, prefill or decode step for the
production mesh on 256 (512 with ``--multi-pod``) forced host devices,
and reads XLA's memory and cost analyses and the HLO's collectives.
The port runs the same step once, eagerly, on this process as rank 0
of a `launch.mesh.fake_world` of 256 (512) ranks over that mesh
(``make_production_mesh``): every tensor is a DTensor whose local shard
lies on the meta device, so nothing is allocated and nothing travels,
but every local operation and every collective that rank 0 would run
is dispatched.  (Fake local shards under ``FakeTensorMode`` would do
as well, but DTensor's cost model reads a tensor it makes itself with
``tolist`` when it plans a redistribution of a strided shard, which
the fake mode refuses.)  Per rank (rank 0; the mesh is uniform) a
record holds:

* ``memory_analysis``: the argument bytes (the local shards of the
  state and inputs); the peak of the live local storages over the step
  (``peak_bytes_per_chip``: each storage counted from the operation that
  makes it until it is freed; no allocator rounding or caching).
  ``torch.distributed._tools.mem_tracker.MemTracker`` is not used: it
  also counts the tensors of global shape that DTensor's sharding
  propagation makes under its own fake mode, and so put yi-6b's
  train_4k cell at 93.75 GiB a rank against 10.49 GiB of live local
  storage;
* ``cost_analysis``: the FLOPs of rank 0's local operations, by
  ``torch.utils.flop_counter``'s formulas, and the bytes those
  operations read and write (each eager operation's operands and
  results, once: no fusion);
* ``collectives``: each collective kind by mesh axis (``all_reduce@
  model``...), its count, its result bytes and its wire bytes (the
  reference's ring factors: 2x for an all-reduce, 1x otherwise);
* ``roofline``: compute, memory and collective seconds (estimates
  from those counts, not times; with no fusion counted the memory term
  is an upper bound) against the peaks of an NVIDIA H100 80GB HBM3
  (SXM) at 700 W: 989 TFLOP/s dense bf16, 3.35 TB/s HBM, 450 GB/s
  NVLink each way (``CARD``), never the reference's TPU constants; the
  card's name and power limit are in the record.

Torch runs every layer eagerly, so every layer's work is counted as it
runs: the reference's two unrolled probes (a fix for XLA's cost
analysis counting a loop body once) are not needed.  ``--jobs N`` runs
the cells in N worker processes, one cell a process (the full sweep at
the published widths); each record's ``compile_seconds`` is its cell's
time.  Without the fake
backend the model mode exits non-zero and says why; it never shrinks
the world.

The skyline cells (``--skyline``).  The
reference lowers and compiles every cell of its skyline suite for 512
forced host devices and reads XLA's ``memory_analysis``, its
``cost_analysis`` and the collectives in the HLO text.  The port has no
compiler to ask: it builds each cell of `repro_torch.launch.cells`
(``SKYLINE_CELLS``; the same names and geometries) on a world of W rank
processes (`repro_torch.launch.mesh.run_world`; in a world of one, in
this process), on the reference's mesh axes scaled to W, runs it once
under the program verifier's dispatch census
(`repro_torch.analysis.verifier.Census`), and records per rank:

* ``memory``: the argument and output bytes, and on the card the peak
  device bytes of the call beyond its inputs (``call_bytes``) and with
  them (``peak_bytes``); on the CPU the peak is not measured;
* ``collectives``: each collective's count, elements (of its results)
  and bytes at the dtype's width, by kind and group (``all_gather@
  workers``...), and for a tree-merge cell the ppermute rounds against
  ⌈log₂ W⌉;
* ``compile_seconds``: the seconds to build the cell and run it once
  (the first cell also pays the world's start, and the kernels' build
  where they are not built yet).

A record has no ``cost_analysis`` and no ``roofline``: torch has no cost
analysis of a compiled module, and the reference's roofline divides by a
TPU's peaks, which are not the card's.  A measured roofline of the card
belongs to a benchmark of the port.  The reference's 512 devices cannot
be 512 processes here; ``--world W`` says how many ranks run (a mesh
axis takes the largest power of two that fits W and divides the cell's
partitions).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      [--arch A] [--shape S] [--multi-pod | --both-meshes] [--smoke] \\
      [--force] [--device cpu|cuda] [--jobs N]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --skyline \\
      [--cell NAME] [--smoke] [--force] [--world W] [--device cpu|cuda]

Records are cached in ``results/dryrun_torch/<cell>.json`` (``--results``
names another directory); a cached ``ok`` (or, for a model cell,
``skipped``) record is kept unless ``--force``.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import json
import multiprocessing
import os
import sys
import time
import traceback
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.verifier import Census, _tensors
from repro_torch.launch.mesh import DTensor

__all__ = ["main", "run_cells", "WireCensus", "RESULTS_DIR", "lower_cell",
           "run_cell", "analyze", "RankCensus", "CARD"]

RESULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "..", "..", "results", "dryrun_torch")
# seconds a spawned world may take for all its cells
DEADLINE_S = 900.0


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class WireCensus(Census):
    """The verifier's census, which also sums each collective's result
    elements and bytes by ``kind@group``."""

    def __init__(self):
        super().__init__()
        self.wire = collections.defaultdict(
            lambda: {"count": 0, "elements": 0, "bytes": 0})

    def record_collective(self, kind, group, fn, x, counted):
        out = super().record_collective(kind, group, fn, x, counted)
        if counted:
            w = self.wire[f"{kind}@{group}"]
            w["count"] += 1
            w["elements"] += out.numel()
            w["bytes"] += out.numel() * out.element_size()
        return out


def _run_cell(name: str, spec: dict, smoke: bool, device) -> dict:
    """One cell on this rank: build, run once under the census."""
    from repro_torch.core.parallel import merge_rounds
    from repro_torch.launch.cells import build_skyline_cell

    t0 = time.perf_counter()
    built = build_skyline_cell(name, spec, smoke=smoke, device=device,
                               meshed=True)
    rec = {"mesh": built.info["mesh"],
           "config": {k: v for k, v in built.info.items() if k != "mesh"}}
    if built.fn is None:
        rec["skipped"] = (f"rank {built.mesh.rank} is outside the cell's "
                          f"{built.mesh.queries} x {built.mesh.workers} mesh")
        return rec
    dev = built.mesh.device if built.mesh is not None else torch.device(
        device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    census = WireCensus()
    with census:
        out = built.fn(*built.args)
    args_bytes = _nbytes(built.args)
    memory = {"argument_bytes": args_bytes, "output_bytes": _nbytes(out)}
    if on_card:
        torch.cuda.synchronize(dev)
        extra = torch.cuda.max_memory_allocated(dev) - base
        memory.update(measured=True, call_bytes=extra,
                      peak_bytes=extra + args_bytes)
    else:
        memory.update(measured=False, call_bytes=None, peak_bytes=None)
    rec["seconds"] = time.perf_counter() - t0
    rec["memory"] = memory
    rec["collectives"] = {k: dict(v) for k, v in sorted(census.wire.items())}
    rec["kernels"] = dict(census.kernels)
    if built.cfg.merge == "tree" and built.mesh is not None:
        rec["tree_rounds"] = {
            "expected": merge_rounds(built.mesh.workers),
            "ppermute": census.wire["ppermute@workers"]["count"]}
    return rec


def _dry_rank(cells: dict, smoke: bool, device) -> dict:
    """Every cell of ``cells`` on this rank, in order; a cell that fails
    is recorded with its error and the rank goes on."""
    out = {}
    for name, spec in cells.items():
        try:
            out[name] = _run_cell(name, spec, smoke, device)
        except Exception as e:  # recorded in the cell's record
            out[name] = {"error": f"{type(e).__name__}: {e}",
                         "traceback": traceback.format_exc()[-4000:]}
    return out


def cell_name(name: str, smoke: bool) -> str:
    return f"skyline__{name}{'__smoke' if smoke else ''}"


def run_cells(cells: dict, *, smoke: bool, world: int, device,
              deadline: float = DEADLINE_S) -> dict[str, dict]:
    """Run ``cells`` on a world of ``world`` ranks; one record per cell
    (see the module docstring)."""
    from repro_torch.launch.mesh import close_world, run_world, world_size

    if world == 1:
        ranks = [_dry_rank(cells, smoke, device)]
        if world_size() == 1:
            close_world()
    else:
        ranks = run_world(_dry_rank, world, cells, smoke, str(device),
                          device=str(device), deadline=deadline)
    records = {}
    for name in cells:
        per_rank = [r[name] for r in ranks]
        errors = [f"rank {i}: {r['error']}" for i, r in enumerate(per_rank)
                  if "error" in r]
        rec: dict = {"cell": cell_name(name, smoke), "chips": world,
                     "device": str(device)}
        if errors:
            rec.update(status="error", error="; ".join(errors),
                       traceback=next(r["traceback"] for r in per_rank
                                      if "error" in r))
        else:
            ran = [r for r in per_rank if "skipped" not in r]
            rec.update(
                status="ok", config=per_rank[0]["config"],
                mesh=per_rank[0]["mesh"],
                compile_seconds=max(r["seconds"] for r in ran),
                memory={str(i): r.get("memory") for i, r in
                        enumerate(per_rank)},
                collectives={str(i): r.get("collectives") for i, r in
                             enumerate(per_rank)},
                kernels={str(i): r.get("kernels") for i, r in
                         enumerate(per_rank)},
                skipped={str(i): r["skipped"] for i, r in
                         enumerate(per_rank) if "skipped" in r})
            if "tree_rounds" in ran[0]:
                rec["tree_rounds"] = ran[0]["tree_rounds"]
        records[name] = rec
    return records


def _peak_desc(rec: dict) -> str:
    peaks = [m["peak_bytes"] for m in rec["memory"].values()
             if m and m.get("measured")]
    if not peaks:
        return "mem/chip=not measured"
    return f"mem/chip={max(peaks) / 2 ** 20:.1f}MiB"


def _all_gather_bytes(rec: dict) -> float:
    return float(max((c or {}).get("all_gather@workers", {}).get("bytes", 0)
                     for c in rec["collectives"].values()))


# --------------------------------------------------------------------------
# The model cells: one step on a fake world of the production mesh
# --------------------------------------------------------------------------

# the card the roofline divides by (H100 SXM datasheet peaks)
CARD = {"name": "NVIDIA H100 80GB HBM3 (SXM)", "power_limit_w": 700.0,
        "peak_flops_bf16_dense": 989e12, "hbm_bytes_per_s": 3.35e12,
        "nvlink_bytes_per_s_each_way": 450e9}
PEAK_FLOPS = CARD["peak_flops_bf16_dense"]
HBM_BW = CARD["hbm_bytes_per_s"]
LINK_BW = CARD["nvlink_bytes_per_s_each_way"]

# wire bytes per rank as a multiple of the collective's result bytes
# (ring algorithms; the reference's factors)
_FACTOR = {"all_gather_into_tensor": 1.0, "all_reduce": 2.0,
           "reduce_scatter_tensor": 1.0, "all_to_all_single": 1.0}


class RankCensus(TorchDispatchMode):
    """Rank 0's local work under a fake world: the FLOPs of every local
    operation (``torch.utils.flop_counter``'s formulas), the bytes its
    operands and results occupy, and every collective by kind and mesh
    axis.  An operation on DTensors is let through
    (``NotImplemented``) so that DTensor runs it as local operations and
    collectives, which this mode then sees with rank 0's shapes.
    (``FlopCounterMode`` itself counts the DTensor operations at their
    global shapes.)"""

    def __init__(self, mesh):
        super().__init__()
        self.axis = {}
        for name in mesh.mesh_dim_names:
            self.axis[mesh.get_group(name).group_name] = name
        self.flops = 0
        self.op_bytes = 0
        self.collectives = collections.defaultdict(
            lambda: {"count": 0, "bytes": 0, "wire_bytes": 0.0})
        self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def track(self, tree) -> None:
        """Count the storages of ``tree``'s local tensors as live from
        now until they are freed (the step's arguments, then every
        local result), and keep the peak of the live bytes."""
        for t in _leaves(tree):
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, FakeTensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in _tensors((args, out))):
            # DTensor's own shape inference (global shapes), not work
            return out
        self.track(out)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        name = packet.__name__
        if name in _FACTOR:
            group = next((self.axis.get(a) for a in args
                          if isinstance(a, str) and a in self.axis), "?")
            c = self.collectives[f"{name}@{group}"]
            nbytes = _nbytes(out)
            c["count"] += 1
            c["bytes"] += nbytes
            c["wire_bytes"] += nbytes * _FACTOR[name]
        elif not func.is_view and func.namespace != "_c10d_functional":
            self.op_bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        return out


def lower_cell(arch: str, shape: str, multi_pod: bool, rules_override=None,
               opt_cfg=None, smoke: bool = False, cfg_override=None,
               device="cpu"):
    """``(cfg, mesh, fn, args)``: the cell's step and its stand-in
    arguments (DTensors over meta shards) on the production mesh of the
    current (fake) world (`run_cell`)."""
    from repro_torch.configs import SHAPES, arch_rules, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import cache_specs, input_specs, state_specs
    from repro_torch.models import transformer as T
    from repro_torch.models.common import Sharder
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step

    cfg = cfg_override or get_config(arch, smoke=smoke)
    spec = SHAPES[shape]
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    rules = arch_rules(cfg, shape, multi_pod=multi_pod)
    if rules_override:
        rules.update(rules_override)
    if opt_cfg is None:
        opt_cfg = OptConfig(
            moment_dtype="bfloat16" if cfg.param_dtype == "bfloat16"
            else "float32")
    sharder = Sharder(rules, enabled=True, mesh=mesh)
    dev = "meta"

    if spec.kind == "train":
        fn = make_train_step(cfg, opt_cfg, rules=rules,
                             shard_activations=True)
        state = state_specs(cfg, mesh, rules, opt_cfg, device=dev)
        # the reference's stand-in moments are one tree; these are written
        state["opt"]["v"] = state_specs(cfg, mesh, rules, opt_cfg,
                                        device=dev)["opt"]["m"]
        args = (state, input_specs(cfg, shape, mesh, rules, device=dev))
    elif spec.kind == "prefill":
        params = state_specs(cfg, mesh, rules, device=dev)["params"]
        batch = input_specs(cfg, shape, mesh, rules, device=dev)
        if cfg.family == "encoder":
            # encoder "inference-prefill" = one full forward pass
            def fn(params, batch):
                return T.forward(params, cfg, batch, sharder=sharder)[0]
        else:
            def fn(params, batch):
                return T.prefill(params, cfg, batch, spec.seq_len,
                                 sharder=sharder)
        args = (params, batch)
    else:  # decode
        params = state_specs(cfg, mesh, rules, device=dev)["params"]
        caches = cache_specs(cfg, shape, mesh, rules, device=dev)
        io = input_specs(cfg, shape, mesh, rules, device=dev)

        def fn(params, caches, token, pos):
            return T.decode_step(params, cfg, caches, token, pos,
                                 sharder=sharder)
        args = (params, caches, io["token"], io["pos"])
    return cfg, mesh, fn, args


def _local_bytes(tree) -> int:
    return sum(_nbytes(x.to_local() if isinstance(x, DTensor) else x)
               for x in _leaves(tree))


def _leaves(tree) -> list:
    from repro_torch.models.transformer import tree_map
    out = []
    tree_map(lambda x: out.append(x), tree)
    return [x for x in out if isinstance(x, torch.Tensor)]


def analyze(cfg, spec, chips, census, *, arg_bytes, seconds):
    coll = {k: dict(v) for k, v in sorted(census.collectives.items())}
    wire = float(sum(v["wire_bytes"] for v in coll.values()))
    terms = {"compute_s": census.flops / PEAK_FLOPS,
             "memory_s": census.op_bytes / HBM_BW,
             "collective_s": wire / LINK_BW}
    n_active = cfg.active_param_count()
    if spec.kind == "train":
        model_flops = 6 * n_active * spec.global_batch * spec.seq_len
    elif spec.kind == "prefill":
        model_flops = 2 * n_active * spec.global_batch * spec.seq_len
    else:
        model_flops = 2 * n_active * spec.global_batch
    total = census.flops * chips
    bound = max(terms.values())
    return {
        "chips": chips,
        "card": CARD,
        "memory_analysis": {"argument_bytes": arg_bytes,
                            "peak_bytes_per_chip": census.peak},
        "cost_analysis": {"flops_per_chip": census.flops,
                          "op_bytes_per_chip": census.op_bytes},
        "collectives": {"per_chip": coll, "per_chip_wire_bytes": wire},
        "roofline": {**terms, "dominant": max(terms, key=terms.get),
                     "bound_s": bound, "model_flops": model_flops,
                     "total_flops": total,
                     "useful_flops_ratio": (model_flops / total
                                            if total > 0 else -1),
                     "model_flops_time_s": model_flops / (chips * PEAK_FLOPS),
                     "roofline_fraction": (
                         model_flops / (chips * PEAK_FLOPS) / bound
                         if bound > 0 else -1)},
        "compile_seconds": seconds,
    }


def model_cell_name(arch: str, shape: str, multi_pod: bool,
                    smoke: bool) -> str:
    return (f"{arch}__{shape}__{'multipod' if multi_pod else 'pod'}"
            f"{'__smoke' if smoke else ''}")


def run_cell(arch: str, shape: str, multi_pod: bool, rules_override=None,
             smoke: bool = False, device="cpu", results=RESULTS_DIR) -> dict:
    """One model cell on a fake world of the production mesh's size;
    its record (see the module docstring), also written to
    ``results``."""
    from repro_torch.configs import SHAPES, get_config, skip_reason
    from repro_torch.launch.mesh import fake_world

    cell = model_cell_name(arch, shape, multi_pod, smoke)
    reason = skip_reason(get_config(arch), shape)
    if reason:
        rec = {"cell": cell, "status": "skipped", "reason": reason}
    else:
        t0 = time.perf_counter()
        try:
            chips = 512 if multi_pod else 256
            with fake_world(chips):
                rec = _meta_step(arch, shape, multi_pod, rules_override,
                                 smoke, device, t0)
            rec = {"cell": cell, "status": "ok", "device": str(device),
                   **rec}
        except Exception as e:  # recorded, not swallowed
            rec = {"cell": cell, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
    os.makedirs(results, exist_ok=True)
    with open(os.path.join(results, cell + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def _meta_step(arch, shape, multi_pod, rules_override, smoke, device, t0):
    from repro_torch.configs import SHAPES

    cfg, mesh, fn, args = lower_cell(arch, shape, multi_pod, rules_override,
                                     smoke=smoke, device=device)
    arg_bytes = _local_bytes(args)
    census = RankCensus(mesh)
    census.track(args)
    with census:
        fn(*args)
    seconds = time.perf_counter() - t0
    return analyze(cfg, SHAPES[shape], mesh.size(), census,
                   arg_bytes=arg_bytes, seconds=seconds)


def _cell_job(arch, shape, mp, smoke, device, results) -> dict:
    """One model cell in a worker process of ``--jobs`` (one intra-op
    thread: the workers share the host's cores)."""
    torch.set_num_threads(1)
    return run_cell(arch, shape, mp, smoke=smoke, device=device,
                    results=results)


def _print_cell(rec: dict) -> None:
    cell, st = rec["cell"], rec["status"]
    if st == "ok":
        r = rec["roofline"]
        m = rec["memory_analysis"]
        peak = f"{m['peak_bytes_per_chip'] / 2 ** 30:.2f}GiB"
        print(f"[ok]     {cell}: dominant={r['dominant']} "
              f"bound={r['bound_s']:.4f}s "
              f"frac={r['roofline_fraction']:.3f} "
              f"args/chip={m['argument_bytes'] / 2 ** 30:.2f}GiB "
              f"peak/chip={peak} "
              f"compile={rec['compile_seconds']:.0f}s", flush=True)
    elif st == "skipped":
        print(f"[skip]   {cell}: {rec['reason']}", flush=True)
    else:
        print(f"[ERROR]  {cell}: {rec['error']}", flush=True)


def _model_main(args) -> int:
    from repro_torch.configs import ARCH_NAMES, SHAPES
    from repro_torch.launch.mesh import has_fake_backend

    if not has_fake_backend():
        print("the model cells run on a fake world of the production "
              "mesh's size, and this torch has no fake process-group "
              "backend (torch.testing._internal.distributed.fake_pg)",
              file=sys.stderr)
        return 2
    archs = [args.arch] if args.arch else ARCH_NAMES
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    counts = collections.Counter()
    todo = []
    for arch in archs:
        for shape in ([args.shape] if args.shape else list(SHAPES)):
            for mp in meshes:
                cell = model_cell_name(arch, shape, mp, args.smoke)
                path = os.path.join(args.results, cell + ".json")
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        rec = json.load(f)
                    if rec.get("status") in ("ok", "skipped"):
                        print(f"[cached] {cell}: {rec['status']}")
                        counts[rec["status"]] += 1
                        continue
                todo.append((arch, shape, mp))

    def done(rec):
        counts[rec["status"]] += 1
        _print_cell(rec)

    if args.jobs <= 1:
        for cell in todo:
            done(run_cell(*cell, smoke=args.smoke, device=args.device,
                          results=args.results))
    else:
        # the longest cells first: training steps, then the prefills
        kind = {"train": 0, "prefill": 1, "decode": 2}
        todo.sort(key=lambda c: (kind[SHAPES[c[1]].kind], not c[2]))
        with concurrent.futures.ProcessPoolExecutor(
                args.jobs, mp_context=multiprocessing.get_context("spawn"),
                max_tasks_per_child=1) as pool:
            futures = [pool.submit(_cell_job, *cell, args.smoke,
                                   args.device, args.results)
                       for cell in todo]
            for f in concurrent.futures.as_completed(futures):
                done(f.result())
    n_err = counts["error"]
    print(f"done: ok={counts['ok']} skip={counts['skipped']} err={n_err}")
    return 1 if n_err else 0


def main(argv=None) -> int:
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.launch.cells import SKYLINE_CELLS

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skyline", action="store_true",
                    help="dry-run the skyline program cells instead of the "
                         "model cells")
    ap.add_argument("--cell", default=None,
                    help="with --skyline: run only this cell")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs (model cells); n / 64, capacity "
                         "/ 16 (skyline cells)")
    ap.add_argument("--force", action="store_true",
                    help="rerun cells with a cached ok record")
    ap.add_argument("--jobs", type=int, default=1,
                    help="model cells: run them in this many worker "
                         "processes, one cell a process")
    ap.add_argument("--world", type=int, default=1,
                    help="with --skyline: ranks of the world the cells run "
                         "on")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the ranks run (default: the card)")
    ap.add_argument("--results", default=RESULTS_DIR,
                    help="directory of the cached records")
    args = ap.parse_args(argv)

    if not args.skyline:
        from repro_torch.configs import ARCH_NAMES, SHAPES
        if args.arch and args.arch not in ARCH_NAMES:
            ap.error(f"unknown arch {args.arch!r}; valid: "
                     f"{', '.join(ARCH_NAMES)}")
        if args.shape and args.shape not in SHAPES:
            ap.error(f"unknown shape {args.shape!r}; valid: "
                     f"{', '.join(SHAPES)}")
        args.device = resolve_device(args.device).type
        return _model_main(args)
    if args.cell and args.cell not in SKYLINE_CELLS:
        ap.error(f"unknown skyline cell {args.cell!r}; valid: "
                 f"{', '.join(SKYLINE_CELLS)}")
    if args.world < 1:
        ap.error("--world must be at least 1")
    device = resolve_device(args.device)
    os.makedirs(args.results, exist_ok=True)

    n_ok = n_err = 0
    todo = {}
    for name, spec in SKYLINE_CELLS.items():
        if args.cell and name != args.cell:
            continue
        cell = cell_name(name, args.smoke)
        path = os.path.join(args.results, cell + ".json")
        if os.path.exists(path) and not args.force:
            with open(path) as f:
                rec = json.load(f)
            if rec.get("status") == "ok":
                print(f"[cached] {cell}: ok")
                n_ok += 1
                continue
        todo[name] = spec
    if todo:
        try:
            records = run_cells(todo, smoke=args.smoke, world=args.world,
                                device=device)
        except RuntimeError as e:   # the world failed as a whole
            records = {name: {"cell": cell_name(name, args.smoke),
                              "status": "error", "chips": args.world,
                              "error": str(e)[-4000:]} for name in todo}
        for name, rec in records.items():
            with open(os.path.join(args.results,
                                   rec["cell"] + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            if rec["status"] == "ok":
                n_ok += 1
                print(f"[ok]     {rec['cell']}: chips={rec['chips']} "
                      f"{_peak_desc(rec)} "
                      f"ag_bytes={_all_gather_bytes(rec):.3e} "
                      f"compile={rec['compile_seconds']:.0f}s")
            else:
                n_err += 1
                print(f"[ERROR]  {rec['cell']}: {rec['error']}")
    print(f"done: ok={n_ok} err={n_err}")
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
