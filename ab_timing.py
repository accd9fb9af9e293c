#!/usr/bin/env python3
"""Time two checkouts of the PyTorch port in turns on one CUDA card.

    python3 ab_timing.py OLD_CHECKOUT NEW_CHECKOUT [--turns ABBA] [--reps 5]

Each turn is a process of its own that imports ``repro_torch`` from the
checkout's ``src`` (its kernels are built into that checkout's
``build/``) and times, by CUDA events after one warm-up, ``--reps``
calls of:

  * the default query (``parallel_skyline``, capacity 65536) on the
    uniform, correlated and anticorrelated data of ``chip_smoke.py``'s
    main path (N = 10^7, d = 4, the same seeds);
  * the 64 ragged requests of ``chip_smoke.py``'s engine step E1 (N from
    2^12 to 2^20, the same seeds, one masked), answered by 64 single
    ``parallel_skyline`` calls, and, where the checkout has the serving
    layer, by one ``SkylineEngine.submit_many``.

The answers' bits are hashed; the hashes must agree across turns and
checkouts, and the batch's with the single calls'.  It prints the
card's name and power limit, every turn's times, then a summary: each
checkout's times as ranges over all its calls, and per turn of the new
checkout the single calls' best time over the batch's.  Run it from a
checkout of the repository; it needs one card and exits non-zero when a
turn fails or the bits differ.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

N_MAIN, D_MAIN = 10_000_000, 4
ENGINE_Q, ENGINE_N_LOG2 = 64, (12, 20)
DISTS = ("uniform", "correlated", "anticorrelated")


def _digest(bufs) -> str:
    import torch
    h = hashlib.sha256()
    for buf in bufs:
        for leaf in buf:
            t = leaf.detach()
            if t.is_floating_point():
                t = t.view(torch.int32)
            h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _times(fn, reps: int) -> list[float]:
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def child(src: str, reps: int) -> None:
    """One turn: time the checkout whose package lies under ``src``."""
    sys.path.insert(0, str(Path(src).resolve()))
    import torch
    from repro_torch.core import api, datagen, parallel
    if not torch.cuda.is_available():
        sys.exit("ab_timing.py: torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    cfg = parallel.SkyConfig(capacity=65536)
    res: dict = {"src": src, "default": {}, "digest": {}}
    for seed, dist in enumerate(DISTS):
        gen = torch.Generator(device=dev).manual_seed(1000 + seed)
        x = datagen.generate(dist, gen, N_MAIN, D_MAIN)
        res["digest"][dist] = _digest([api.parallel_skyline(x, cfg=cfg)[0]])
        res["default"][dist] = _times(
            lambda: api.parallel_skyline(x, cfg=cfg), reps)
        del x
    g = torch.Generator().manual_seed(2024)
    lo, hi = ENGINE_N_LOG2
    sizes = [int(2 ** (lo + (hi - lo) * float(u)))
             for u in torch.rand(ENGINE_Q, generator=g)]
    sizes[0], sizes[1] = 2 ** lo, 2 ** hi
    data, masks = [], []
    for i, n in enumerate(sizes):
        gen = torch.Generator(device=dev).manual_seed(5000 + i)
        data.append(datagen.generate(DISTS[i % 3], gen, n, D_MAIN))
        masks.append(torch.rand((n,), generator=gen, device=dev) > 0.3
                     if i == 5 else None)

    def singles():
        return [api.parallel_skyline(x, m, cfg=cfg)[0]
                for x, m in zip(data, masks)]

    res["digest"]["e1"] = _digest(singles())
    res["singles"] = _times(singles, reps)
    try:
        from repro_torch.serve.engine import SkylineEngine, SkylineRequest
    except ImportError:
        res["batch"] = None
    else:
        engine = SkylineEngine(cfg, device=dev)
        reqs = [SkylineRequest(data=x, mask=m) for x, m in zip(data, masks)]
        got = _digest([b for b, _ in engine.submit_many(reqs)])
        if got != res["digest"]["e1"]:
            sys.exit(f"ab_timing.py: the batch's bits ({got}) differ from "
                     f"the single calls' ({res['digest']['e1']})")
        res["batch"] = _times(lambda: engine.submit_many(reqs), reps)
    print(json.dumps(res))


def _span(ts) -> str:
    ts = sorted(ts)
    return (f"{ts[0]:.3f}..{ts[-1]:.3f} ms (median {ts[len(ts) // 2]:.3f}, "
            f"{len(ts)} calls)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", nargs="?")
    ap.add_argument("new", nargs="?")
    ap.add_argument("--turns", default="ABBA")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--child", metavar="SRC")
    args = ap.parse_args()
    if args.child:
        child(args.child, args.reps)
        return
    if not (args.old and args.new) or set(args.turns) - {"A", "B"}:
        ap.error("give OLD_CHECKOUT NEW_CHECKOUT and turns of A and B")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        sys.exit(f"ab_timing.py: nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0].strip())
    trees = {"A": args.old, "B": args.new}
    runs = []
    for turn in args.turns:
        src = str(Path(trees[turn]) / "src")
        proc = subprocess.run([sys.executable, __file__, "--child", src,
                               "--reps", str(args.reps)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.exit(f"ab_timing.py: turn {turn} ({src}) failed:\n"
                     f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["turn"] = turn
        runs.append(res)
        print(json.dumps(res))
    digests = {json.dumps(r["digest"], sort_keys=True) for r in runs}
    if len(digests) != 1:
        sys.exit(f"ab_timing.py: the answers' bits differ between turns: "
                 f"{digests}")
    print("bits: every turn's answers hash alike "
          f"{runs[0]['digest']}")
    for turn, tree in trees.items():
        mine = [r for r in runs if r["turn"] == turn]
        for dist in DISTS:
            print(f"{turn} {tree} default query {dist}: "
                  f"{_span([t for r in mine for t in r['default'][dist]])}")
        print(f"{turn} {tree} 64 single calls: "
              f"{_span([t for r in mine for t in r['singles']])}")
        if all(r["batch"] is not None for r in mine):
            print(f"{turn} {tree} the batch: "
                  f"{_span([t for r in mine for t in r['batch']])}; single "
                  f"calls over the batch, best of each turn: "
                  + ", ".join(f"{min(r['singles']) / min(r['batch']):.3f}x"
                              for r in mine))


if __name__ == "__main__":
    main()
