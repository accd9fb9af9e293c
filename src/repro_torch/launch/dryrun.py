"""Skyline dry run: build and run each program cell once on a world of
ranks, and record its memory and its collectives.

Counterpart of the ``--skyline`` half of ``repro.launch.dryrun``.  The
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
partitions).  The reference's model cells (without ``--skyline``) are
not ported: the port has no model code yet (ROADMAP item 14c), and that
mode exits non-zero.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --skyline \\
      [--cell NAME] [--smoke] [--force] [--world W] [--device cpu|cuda]

Records are cached in ``results/dryrun_torch/<cell>.json`` (``--results``
names another directory); a cached ``ok`` record is kept unless
``--force``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.analysis.verifier import Census, _tensors

__all__ = ["main", "run_cells", "WireCensus", "RESULTS_DIR"]

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


def main(argv=None) -> int:
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.launch.cells import SKYLINE_CELLS

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--skyline", action="store_true",
                    help="dry-run the skyline program cells (the only mode "
                         "the port has)")
    ap.add_argument("--cell", default=None,
                    help="run only this cell")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke sizes (n / 64, capacity / 16)")
    ap.add_argument("--force", action="store_true",
                    help="rerun cells with a cached ok record")
    ap.add_argument("--world", type=int, default=1,
                    help="ranks of the world the cells run on")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="where the ranks run (default: the card)")
    ap.add_argument("--results", default=RESULTS_DIR,
                    help="directory of the cached records")
    args = ap.parse_args(argv)

    if not args.skyline:
        print("the model cells of the reference's dry run are not ported "
              "(the port has no model code yet, ROADMAP item 14c); run "
              "with --skyline", file=sys.stderr)
        return 2
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
