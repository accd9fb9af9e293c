"""Quickstart: compute skylines sequentially and in parallel.

Counterpart of ``examples/quickstart.py``: the sequential block-SFS
(paper Algorithm 1), then `parallel_skyline` (Algorithm 2) under each
partitioning strategy and under NoSeq, each answer's size asserted equal
to the sequential one.

  python -m repro_torch.examples.quickstart                 # on the card
  python -m repro_torch.examples.quickstart --device cpu

``--n`` cuts the dataset (the reference's 50,000 x 4).  The
points come from a torch generator seeded with 0, so the sizes printed
differ from the reference's, whose points come from ``jax.random``.
`main` returns the points and every answer.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.api import parallel_skyline, skyline
from repro_torch.core.datagen import generate
from repro_torch.core.parallel import SkyConfig
from repro_torch.kernels.backend import resolve_device

__all__ = ["STRATEGIES", "strategy_config", "NOSEQ", "main"]

STRATEGIES = ("random", "grid", "angular", "sliced")
NOSEQ = SkyConfig(strategy="sliced", p=8, capacity=8192, local_capacity=2048,
                  rep_filter="sorted", noseq=True)


def strategy_config(strategy: str) -> SkyConfig:
    return SkyConfig(strategy=strategy, p=8, capacity=8192,
                     local_capacity=2048,
                     bucket_factor=8.0 if strategy == "grid" else 3.0,
                     rep_filter="sorted")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--device", default=None,
                    help="where to run (default: the card; 'cpu' runs on "
                         "the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, d = args.n, 4
    pts = generate("anticorrelated",
                   torch.Generator(device=dev).manual_seed(0), n, d)
    print(f"dataset: {n} tuples, {d} dims, anticorrelated")
    out = {"points": pts}

    # --- sequential block-SFS (paper Algorithm 1) ---
    t0 = time.perf_counter()
    sky = skyline(pts, capacity=8192, device=dev)
    _sync(dev)
    out["sequential"] = sky
    print(f"sequential SFS: |SKY| = {int(sky.count)} "
          f"({time.perf_counter() - t0:.2f}s incl. compile)")

    # --- parallel pattern (paper Algorithm 2) with each strategy ---
    for strategy in STRATEGIES:
        t0 = time.perf_counter()
        buf, stats = parallel_skyline(pts, cfg=strategy_config(strategy),
                                      device=dev)
        _sync(dev)
        assert int(buf.count) == int(sky.count)
        out[strategy] = (buf, stats)
        print(f"parallel {strategy:8s}: |SKY| = {int(buf.count)}, "
              f"union = {int(stats['union_size'])}, "
              f"overflow = {bool(buf.overflow)} "
              f"({time.perf_counter() - t0:.2f}s)")

    # --- NoSeq: fully parallel second phase (paper §4.2) ---
    buf, stats = parallel_skyline(pts, cfg=NOSEQ, device=dev)
    assert int(buf.count) == int(sky.count)
    out["noseq"] = (buf, stats)
    print(f"NoSeq(sliced+):    |SKY| = {int(buf.count)} — phase 2 runs "
          f"per-worker against the potential-dominator sets")

    print("done — all strategies agree with the sequential skyline")
    return out


if __name__ == "__main__":
    main()
