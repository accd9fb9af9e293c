"""Streaming example: device-resident skyline maintenance over arriving
data, plus incrementally maintained Pareto-front request admission.

Counterpart of ``examples/streaming_pareto.py``.  A product catalogue
arrives in waves; a serving layer must expose the current Pareto front
after every wave without re-scanning history.  `SkylineEngine.
open_stream` keeps one `SkylineState` per tenant on the device, leased
from the engine's shared slab arena: each wave is ONE insert dispatch
for all tenants, and `snapshot()` is bit for bit what a full recompute
over everything seen so far would return.

The sliding-window scenario adds time decay: listings expire after W
waves (``StreamOptions(window_epochs=W)``, an epoch ring per tenant).
`tick()` ages every tenant's window in one dispatch; a member the
expired wave had been suppressing resurfaces, because each epoch
retains its own local skyline and the front is merged on read.

  python -m repro_torch.examples.streaming_pareto           # on the card
  python -m repro_torch.examples.streaming_pareto --device cpu

The wave sizes and requests are the reference's (numpy, seed 0); the
points come from torch generators, so the fronts printed differ from
the reference's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.datagen import generate
from repro_torch.core.parallel import SkyConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.serve.engine import SkylineEngine, StreamOptions
from repro_torch.serve.scheduler import Request, StreamingAdmitter

__all__ = ["main"]


def _points(dist: str, seed: int, n: int, dev) -> torch.Tensor:
    return generate(dist, torch.Generator(device=dev).manual_seed(seed),
                    int(n), 4)


def main(argv=None) -> SkylineEngine:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.streaming_pareto")
    ap.add_argument("--device", default=None,
                    help="where to run (default: the card; 'cpu' runs on "
                         "the CPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    engine = SkylineEngine(SkyConfig(strategy="sliced", p=4, capacity=512,
                                     block=64, bucket_factor=4.0),
                           device=dev)

    # --- two tenants' catalogues arriving in ragged waves ---------------
    stream = engine.open_stream(d=4, options=StreamOptions(q=2))
    dists = ("anticorrelated", "uniform")
    t0 = time.time()
    for wave in range(5):
        sizes = rng.integers(40, 200, size=2)
        chunks = [_points(dist, 10 * wave + j, n, dev)
                  for j, (dist, n) in enumerate(zip(dists, sizes))]
        if wave == 3:
            chunks[1] = None  # tenant 1 idle this wave
        stream.feed(chunks)
        c = stream.counters()
        print(f"wave {wave}: arrivals {[0 if ch is None else len(ch) for ch in chunks]}"
              f" -> front sizes {c['count'].tolist()} "
              f"(seen {c['seen'].tolist()})")
    fronts = stream.snapshot()
    print(f"{stream.chunks_fed} waves in {time.time() - t0:.2f}s; final "
          f"fronts: {[int(b.count) for b in fronts]} members "
          f"(device-resident throughout, zero recomputes)")

    # --- sliding window: listings expire after 3 waves ------------------
    win = engine.open_stream(d=4, options=StreamOptions(q=2,
                                                        window_epochs=3))
    for wave in range(6):
        chunks = [_points(dist, 100 * wave + j, n, dev)
                  for j, (dist, n) in enumerate(
                      zip(dists, rng.integers(40, 200, size=2)))]
        win.feed(chunks)
        fronts = [int(b.count) for b in win.snapshot()]
        aged = win.tick() if wave < 5 else False
        print(f"window wave {wave}: live-window fronts {fronts}"
              f"{'  (oldest wave aged out, O(1))' if aged else ''}")
    c = win.counters()
    print(f"sliding window: retained candidates {c['count'].tolist()} "
          f"across 3 epochs/tenant; expiry never recomputes — dominance "
          f"across epochs is resolved when the front is read")

    # one arena per (d, dtype, epochs, slot-rows) bucket serves ALL
    # tenant streams: device buffers are O(#buckets), not O(#streams)
    print(f"slab arenas: "
          f"{[(k, v['slots'], v['leased']) for k, v in sorted(engine.arena_report().items())]}")

    # --- streaming admission: the request pool trickles in --------------
    adm = StreamingAdmitter(queues=2, engine=engine)
    for wave in range(4):
        adm.offer([Request(
            slack=rng.exponential(10.0, 16).astype(np.float32),
            neg_priority=(-rng.integers(0, 3, 16)).astype(np.float32),
            cost=rng.integers(8, 64, 16).astype(np.float32))
            for _ in range(2)])
        print(f"admission wave {wave}: front sizes "
              f"{[f.shape[0] for f in adm.fronts()]} of "
              f"{(wave + 1) * 16} offered per queue")
    for qi, batch in enumerate(adm.admit(4)):
        print(f"queue {qi}: admit {batch.shape[0]} most-urgent front "
              f"requests; criteria rows:\n{np.round(batch, 2)}")
    return engine


if __name__ == "__main__":
    main()
