"""Distributed skyline on a world of ranks: partition-per-worker local
skylines, representative broadcast, NoSeq parallel merge.

Counterpart of ``examples/distributed_skyline.py``, which re-execs
itself with eight forced host devices.  Here `launch.mesh.run_world`
spawns a world of W ranks (default 8): on the CPU they join under gloo,
and on the card they share it (gloo, the card's tensors staged as the
mesh module describes).  Every rank runs the sliced strategy with
p = 16 on its workers mesh, sequential merge and NoSeq, and asserts that
the distributed answer has the sequential skyline's size; rank 0's
report is printed.

  python -m repro_torch.examples.distributed_skyline              # card
  python -m repro_torch.examples.distributed_skyline --device cpu

``--world`` and ``--n`` cut the world and the dataset (the reference's
8 workers and 40,000 x 4).  The points come from a torch generator
seeded with 0, the same on every rank, so the sizes printed differ from
the reference's, whose points come from ``jax.random``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.api import parallel_skyline, skyline
from repro_torch.core.datagen import generate
from repro_torch.core.parallel import SkyConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.mesh import make_worker_mesh, run_world

__all__ = ["main", "rank_report"]

DEADLINE_S = 600.0          # the whole run, spawning included
GROUP_TIMEOUT_S = 120.0     # each collective


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rank_report(n: int, device=None) -> dict:
    """One rank of the world: the sequential skyline, then the sliced
    query on the world's workers mesh under each merge, each asserted to
    have the sequential skyline's size.  Its counts, local sizes, union
    and seconds, by merge.  ``device`` is the world's (None: the
    card)."""
    mesh = make_worker_mesh(device=device)
    dev = mesh.device
    pts = generate("anticorrelated",
                   torch.Generator(device=dev).manual_seed(0), n, 4)
    ref = skyline(pts, capacity=8192, device=dev)
    out = {"workers": mesh.workers, "backend": mesh.backend, "runs": []}
    for noseq in (False, True):
        cfg = SkyConfig(strategy="sliced", p=16, capacity=8192,
                        local_capacity=1024, rep_filter="sorted",
                        noseq=noseq)
        t0 = time.perf_counter()
        buf, stats = parallel_skyline(pts, cfg=cfg, mesh=mesh)
        _sync(dev)
        dt = time.perf_counter() - t0
        sizes = stats["local_sizes"].cpu().numpy()
        assert int(buf.count) == int(ref.count), (int(buf.count),
                                                  int(ref.count))
        out["runs"].append({"noseq": noseq, "count": int(buf.count),
                            "min": int(np.min(sizes)),
                            "max": int(np.max(sizes)),
                            "union": int(stats["union_size"]), "s": dt})
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.distributed_skyline")
    ap.add_argument("--world", type=int, default=8)
    ap.add_argument("--n", type=int, default=40_000)
    ap.add_argument("--device", default=None,
                    help="where the ranks run (default: the card, shared "
                         "by every rank; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"mesh: {args.world} workers")
    # the rank function by its module's name, so that spawned ranks find
    # it when this file runs as __main__
    from repro_torch.examples import distributed_skyline as this
    reports = run_world(this.rank_report, args.world, args.n, args.device,
                        device=dev.type, deadline=DEADLINE_S,
                        timeout=GROUP_TIMEOUT_S)
    for run in reports[0]["runs"]:
        print(f"{'NoSeq' if run['noseq'] else 'seq-merge':9s}: "
              f"|SKY|={run['count']}  local sizes "
              f"min/max={run['min']}/{run['max']}  "
              f"union={run['union']}  ({run['s']:.2f}s)")
    print("distributed == sequential: OK")
    return reports


if __name__ == "__main__":
    main()
