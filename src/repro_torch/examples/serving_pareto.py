"""Serving example: batched multi-query skylines + Pareto-front request
admission, both through the `SkylineEngine`'s request surface
(`SkylineRequest` -> `submit_many`), an async serve-loop pass with
deadlines, then batched prefill/greedy decode on the port's model stack.

Counterpart of ``examples/serving_pareto.py``.

  python -m repro_torch.examples.serving_pareto             # on the card
  python -m repro_torch.examples.serving_pareto --device cpu

The masks, sizes, requests and prompts are the reference's (numpy, seed
0); the points come from torch generators and the model's parameters
from ``init_params(seed=0)``, so the fronts and tokens printed differ
from the reference's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.datagen import generate as gen_points
from repro_torch.core.parallel import SkyConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.serve import generate
from repro_torch.models import transformer as T
from repro_torch.models.common import init_params
from repro_torch.serve.api import SkylineRequest
from repro_torch.serve.engine import SkylineEngine
from repro_torch.serve.loop import ServeLoop
from repro_torch.serve.scheduler import Request, admit

__all__ = ["main"]


def _points(dist: str, seed: int, n: int, dev) -> torch.Tensor:
    return gen_points(dist, torch.Generator(device=dev).manual_seed(seed),
                      n, 4)


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serving_pareto")
    ap.add_argument("--device", default=None,
                    help="where to run (default: the card; 'cpu' runs on "
                         "the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)

    # --- batched skyline queries: 8 users, each caring about a different
    # subset of the catalogue's attributes, answered in ONE dispatch ---
    engine = SkylineEngine(SkyConfig(strategy="sliced", p=4, capacity=512,
                                     block=64, bucket_factor=4.0),
                           device=dev)
    catalogue = _points("anticorrelated", 7, 400, dev)
    dim_masks = rng.random((8, 4)) < 0.6
    dim_masks[:, 0] = True
    t0 = time.time()
    # requests sharing one `data` object stack into a single broadcast
    # dispatch (the subspace-view fast path)
    views = engine.submit_many([
        SkylineRequest(data=catalogue, subspace=m) for m in dim_masks])
    sizes = [int(buf.count) for buf, _ in views]
    print(f"engine: {len(views)} subspace skyline queries in "
          f"{engine.batches_dispatched} dispatch(es), "
          f"{time.time() - t0:.2f}s; front sizes {sizes}")

    # --- the same engine behind the async serve loop: Poisson-ish
    # arrivals, dispatch-ahead double buffering, per-request deadlines ---
    with ServeLoop(engine, depth=2) as loop:
        tickets = [loop.submit(SkylineRequest(
            data=_points("uniform", 50 + i, int(rng.integers(100, 300)),
                         dev),
            deadline=time.monotonic() + 5.0)) for i in range(6)]
        loop.drain()
    lat = [t.latency * 1e3 for t in tickets if t.status == "ok"]
    print(f"serve loop: {len(lat)} queries ok over "
          f"{loop.stats['waves']} wave(s), worst latency "
          f"{max(lat):.1f}ms (host pack overlapped with device compute)")

    # --- engine-backed admission: 32 queued requests ---
    reqs = Request(
        slack=rng.exponential(10.0, 32).astype(np.float32),
        neg_priority=(-rng.integers(0, 3, 32)).astype(np.float32),
        cost=rng.integers(8, 64, 32).astype(np.float32))
    picked, front = admit(reqs, batch_size=4, engine=engine)
    picked = picked.cpu().numpy()
    front = front.cpu().numpy()
    print(f"Pareto front: {int(front.sum())} of 32 requests; "
          f"admitted batch: {list(picked)}")
    for i in picked:
        print(f"  req {i:2d}: slack={float(reqs.slack[i]):5.1f}s "
              f"prio={-int(reqs.neg_priority[i])} "
              f"cost={int(reqs.cost[i])} tok "
              f"{'(front)' if bool(front[i]) else ''}")

    cfg = get_config("mixtral-8x7b", smoke=True)
    params = init_params(T.lm_plan(cfg), seed=0, device=dev)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)).to(dev)
    t0 = time.time()
    toks = generate(params, cfg, prompts, gen=16, cache_len=64)
    toks = toks.cpu()
    dt = time.time() - t0
    print(f"generated {toks.shape[0]}x{toks.shape[1]} tokens in {dt:.2f}s "
          f"(smoke-size MoE model, {dev.type.upper()})")
    return toks


if __name__ == "__main__":
    main()
