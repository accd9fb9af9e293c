#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the skyline system on one NVIDIA GPU.

Run from the root of a checkout, on a host with one CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernel from the sources in the checkout
(into build/), then:

  1. prints the card (nvidia-smi name and power limit) and the versions;
  2. prints the build time and the compiler's registers / shared memory /
     spills for each kernel instantiation;
  3. holds the SFS sweep kernel against its plain PyTorch version, bit
     for bit, on the card, over ties, antichains, overflow, block 2,
     d 2..12, -0.0 and subnormal coordinates;
  4. runs the main path, ``parallel_skyline`` at the default config with
     capacity 65536, on uniform, correlated and anticorrelated data at
     N = 10^7, d = 4: two sweep launches per query, no overflow, and bit
     for bit the plain version's answer on the card; then, at smaller
     sizes, the card against the CPU on tie-heavy data with -0.0, the
     member set against the O(N^2) oracle, and overflow at the default
     capacity 4096;
  5. times the query end to end, its stages, and each sweep call (the
     kernel, the plain version, and the least time the card could take);
  6. prints one JSON line per kernel, then the device line.

Every check that fails ends the run with a non-zero exit code.  The
script needs a CUDA card; without one, or outside a checkout of the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import platform
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

N_MAIN = 10_000_000
D_MAIN = 4
MEM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
SOURCE = "src/repro_torch/kernels/sfs/csrc/sfs_sweep.cu"
REPLACES = ("src/repro/kernels/sfs/kernel.py:272, "
            "src/repro/kernels/sfs/gpu.py:95")


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str):
    if not ok:
        fail(msg)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a.cpu(), b.cpu()))


def leaves_equal(got, want) -> bool:
    return all(bits_equal(g, w) for g, w in zip(got, want))


def abs_err(got, want) -> float:
    """Largest |difference| between two windows (0.0 when the bits agree)."""
    return float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0


def time_ms(fn, reps: int = 3):
    """Best of ``reps`` timed calls after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return min(times), times


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA "
             "card")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import api, datagen, parallel, sfs
    from repro_torch.core.dominance import SENTINEL
    from repro_torch.kernels import build
    from repro_torch.kernels.sfs import kernel, ops

    dev = torch.device("cuda")
    gpu = torch.cuda.get_device_name(0)

    # -- 1. card and versions --------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    tag = f"[{card}]"
    print(card)
    print(f"python {platform.python_version()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"{tag} built {len(libs)} CUDA librar{'y' if len(libs) == 1 else 'ies'}"
          f" in {time.perf_counter() - t0:.3f} s: "
          f"{', '.join(p.name for p in libs.values())}")
    entry_d = None
    props = {}
    for line in build.build_log("sfs_sweep").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            dm = re.search(r"ILi(\d+)E", m.group(1))
            entry_d = int(dm.group(1)) if dm else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry_d is not None:
            props.setdefault(entry_d, {})["spills"] = (
                f"{m.group(1)} B spill stores, {m.group(2)} B spill loads")
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and entry_d is not None:
            props.setdefault(entry_d, {})["used"] = (
                f"{m.group(1)} registers, {m.group(2)} B shared memory")
    check(bool(props), "no -Xptxas -v report in the build log")
    for d_inst in sorted(props):
        p = props[d_inst]
        print(f"ptxas sfs_sweep_kernel<D={d_inst}>: {p.get('used', '?')}, "
              f"{p.get('spills', '?')}")

    max_err = 0.0

    # -- 3. kernel against the plain version, bit for bit -------------------
    def case_data(kind, p, n, d, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        if kind == "ties":
            x = torch.randint(0, 5, (p, n, d), generator=g, device=dev) / 5
        elif kind == "simplex":    # an antichain: every valid row is kept
            x = torch.rand((p, n, d), generator=g, device=dev) + 1e-3
            x = x / x.sum(-1, keepdim=True)
        elif kind == "negzero":
            x = torch.tensor([[[-0.0, 0.5], [0.25, 0.25], [0.5, -0.0],
                               [0.75, -1.0], [1.0, 1.0], [0.125, 0.625]]],
                             device=dev).expand(p, n, d).contiguous()
        else:                      # subnormal and zero coordinates
            x = torch.randint(0, 4, (p, n, d), generator=g, device=dev) \
                * 1e-40
            x[torch.rand((p, n, d), generator=g, device=dev) < 0.2] = -0.0
        mask = torch.rand((p, n), generator=g, device=dev) > 0.1
        if kind == "negzero":
            mask[:] = True
        return x.float(), mask

    cases = [  # kind, P, n, d, capacity, block
        ("ties", 8, 1000, 4, 1000, 256),
        ("simplex", 8, 2000, 4, 64, 32),       # capacity << n: overflow
        ("simplex", 1, 3000, 7, 4096, 512),
        ("simplex", 8, 120, 2, 48, 2),         # block 2
        ("ties", 1, 200, 2, 256, 2),
        ("simplex", 8, 600, 12, 640, 32),      # d 12
        ("negzero", 1, 6, 2, 6, 2),
        ("denormal", 2, 400, 3, 512, 32),
    ]
    for i, (kind, p, n, d, cap, blk) in enumerate(cases):
        x, mask = case_data(kind, p, n, d, seed=i)
        pts_p, mask_p, blk_e, wcap = sfs.sweep_inputs(x, mask, capacity=cap,
                                                      block=blk)
        kw = dict(block=blk_e, wcap=wcap, sentinel=SENTINEL)
        got = ops.sfs_sweep(pts_p, mask_p, spec="cuda", **kw)
        torch.cuda.synchronize()
        want = ops.sfs_sweep(pts_p, mask_p, spec="torch", **kw)
        oracle = ops.sfs_sweep(pts_p, mask_p, spec="perpair", **kw)
        max_err = max(max_err, abs_err(got[0], want[0]))
        check(leaves_equal(got, want),
              f"kernel differs from the plain version on case {kind} P={p} "
              f"n={n} d={d} capacity={cap} block={blk}")
        check(leaves_equal(want, oracle),
              f"plain version differs from perpair on case {kind}")
        if kind == "negzero":
            check(bool(torch.signbit(got[0][got[1]]).any()),
                  "-0.0 member lost its sign")
        print(f"kernel case {kind} P={p} n={n} d={d} capacity={cap} "
              f"block={blk}: bitwise equal to the plain version and perpair "
              f"(counts {got[2].tolist()})")

    # -- 4. the main path on the card ---------------------------------------
    cfg = parallel.SkyConfig(capacity=65536)
    plain = dataclasses.replace(cfg, impl="torch")
    data = {}
    launches = {}
    sky_size = {}
    for seed, dist in enumerate(("uniform", "correlated", "anticorrelated")):
        gen = torch.Generator(device=dev).manual_seed(1000 + seed)
        x = datagen.generate(dist, gen, N_MAIN, D_MAIN)
        data[dist] = x
        kernel.sfs_sweep_cuda.launches = 0
        buf, stats = api.parallel_skyline(x, cfg=cfg)
        torch.cuda.synchronize()
        launches[dist] = kernel.sfs_sweep_cuda.launches
        check(launches[dist] == 2,
              f"{dist}: {launches[dist]} sweep launches, expected 2")
        check(not bool(buf.overflow), f"{dist}: overflow at capacity 65536")
        check(buf.points.shape == (65536, D_MAIN)
              and bool(torch.isfinite(buf.points).all()),
              f"{dist}: result of the wrong shape or not finite")
        sky_size[dist] = int(buf.count)
        ref, rstats = api.parallel_skyline(x, cfg=plain)
        max_err = max(max_err, abs_err(buf.points, ref.points))
        check(leaves_equal(buf, ref),
              f"{dist}: card result differs from impl='torch'")
        check(all(bits_equal(stats[k], rstats[k]) for k in rstats),
              f"{dist}: stats differ from impl='torch'")
        print(f"main path {dist} N={N_MAIN} d={D_MAIN}: skyline "
              f"{int(buf.count)}, union {int(stats['union_size'])}, local "
              f"sizes {stats['local_sizes'].tolist()}, {launches[dist]} "
              f"launches, no overflow, bitwise equal to impl='torch'")

    # signed zeros: how the card's own sort orders them, and the port's
    # answer on the card against the CPU on tie-heavy data with -0.0
    for size in (2 ** 12, 2 ** 22):
        zeros = torch.tensor([0.0, -0.0], device=dev).repeat(size // 2)
        raw = torch.sort(zeros, stable=True).indices
        kept = bool(torch.equal(raw, torch.arange(size, device=dev)))
        print(f"torch.sort(stable=True) of {size} alternating +0.0/-0.0 on "
              f"the card keeps them in input order: {kept}")
    g = torch.Generator().manual_seed(7)
    xz = (torch.randint(0, 16, (200_000, D_MAIN), generator=g) / 16).float()
    xz[torch.rand(xz.shape, generator=g) < 0.05] = -0.0
    on_card, card_stats = api.parallel_skyline(xz.to(dev))
    on_cpu, cpu_stats = api.parallel_skyline(xz, device="cpu")
    check(leaves_equal(on_card, on_cpu)
          and all(bits_equal(card_stats[k], cpu_stats[k]) for k in cpu_stats),
          "tie-heavy -0.0 data: the card's result differs from the CPU's")
    check(bool(torch.signbit(on_card.points[on_card.mask]).any()),
          "tie-heavy -0.0 data: no -0.0 coordinate survived")
    print(f"signed zeros N=200000 d={D_MAIN}: card result (skyline "
          f"{int(on_card.count)}) bitwise equal to the CPU's")

    gen = torch.Generator(device=dev).manual_seed(11)
    xo = datagen.anticorrelated(gen, 100_000, D_MAIN)
    small, _ = api.parallel_skyline(xo, cfg=cfg)
    check(not bool(small.overflow), "N=100000: overflow at capacity 65536")
    members = api.skyline_mask_exact(xo)
    got_set = {tuple(r) for r in
               small.points[small.mask].view(torch.int32).tolist()}
    want_set = {tuple(r) for r in xo[members].view(torch.int32).tolist()}
    check(got_set == want_set and int(small.count) == int(members.sum()),
          f"N=100000: member set differs from the O(N^2) oracle "
          f"({int(small.count)} members, oracle {int(members.sum())})")
    print(f"oracle check anticorrelated N=100000 d={D_MAIN}: "
          f"{int(small.count)} members, the same set as the O(N^2) oracle")

    check(sky_size["anticorrelated"] > 4096, "the anticorrelated skyline "
          "does not exceed the default capacity 4096")
    xa = data["anticorrelated"]
    over, _ = api.parallel_skyline(xa)
    over_ref, _ = api.parallel_skyline(
        xa, cfg=parallel.SkyConfig(impl="torch"))
    check(bool(over.overflow), "anticorrelated N=10^7 at capacity 4096: "
          "no overflow flagged")
    check(leaves_equal(over, over_ref), "overflow at capacity 4096: kept "
          "rows differ from the plain version")
    print(f"overflow anticorrelated N={N_MAIN} capacity 4096: skyline "
          f"{sky_size['anticorrelated']} > 4096, overflow flagged, "
          f"{int(over.mask.sum())} rows kept (count {int(over.count)}), "
          f"bitwise equal to impl='torch'")

    # -- 5. times -----------------------------------------------------------
    def sweep_calls(x):
        """The two sweep calls of one query, with their inputs."""
        mask = torch.ones((x.shape[0],), dtype=torch.bool, device=dev)
        buckets, _ = parallel.partition_stage(x, mask, cfg)
        local_cap = cfg.local_capacity or buckets.points.shape[1]
        first = sfs.sweep_inputs(buckets.points, buckets.mask,
                                 capacity=local_cap, block=cfg.block)
        sky, _ = parallel.local_stage(buckets.points, buckets.mask, cfg)
        u = parallel.compact_union(sky, cfg)
        second = sfs.sweep_inputs(u.points[None], u.mask[None],
                                  capacity=cfg.capacity, block=cfg.block)
        return {"local": first, "merge": second}

    record = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
    for dist, x in data.items():
        e2e, runs = time_ms(lambda: api.parallel_skyline(x, cfg=cfg))
        print(f"{tag} end-to-end parallel_skyline {dist} N={N_MAIN} "
              f"d={D_MAIN}: {e2e:.3f} ms best of 3 "
              f"({', '.join(f'{t:.3f}' for t in runs)})")
        mask = torch.ones((x.shape[0],), dtype=torch.bool, device=dev)
        buckets, _ = parallel.partition_stage(x, mask, cfg)
        sky, _ = parallel.local_stage(buckets.points, buckets.mask, cfg)
        t_part, _ = time_ms(lambda: parallel.partition_stage(x, mask, cfg))
        t_local, _ = time_ms(
            lambda: parallel.local_stage(buckets.points, buckets.mask, cfg))
        t_merge, _ = time_ms(lambda: parallel.merge_stage(sky, cfg))
        print(f"{tag} stages of one {dist} query N={N_MAIN} d={D_MAIN}: "
              f"partition {t_part:.3f} ms, local {t_local:.3f} ms, merge "
              f"{t_merge:.3f} ms")
        for call, (pts_p, mask_p, blk, wcap) in sweep_calls(x).items():
            kw = dict(block=blk, wcap=wcap, sentinel=SENTINEL)
            t_k, _ = time_ms(lambda: ops.sfs_sweep(pts_p, mask_p,
                                                   spec="cuda", **kw))
            t_p, _ = time_ms(lambda: ops.sfs_sweep(pts_p, mask_p,
                                                   spec="torch", **kw))
            p, npad, d = pts_p.shape
            nbytes = p * npad * (4 * d + 1) + p * wcap * (4 * d + 1) + 4 * p
            compares = count_compares(pts_p, mask_p, blk, wcap)
            ops_n = 2 * d * compares
            t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
            t_ops = ops_n / F32_OPS_PER_S * 1e3
            bound = max(t_bytes, t_ops)
            print(f"{tag} sfs_sweep {call} call ({dist} N={N_MAIN}: P={p}, "
                  f"npad={npad}, d={d}, block={blk}, wcap={wcap}): kernel "
                  f"{t_k:.3f} ms, plain {t_p:.3f} ms, bound {bound:.6f} ms "
                  f"set by {'bytes' if t_bytes >= t_ops else 'operations'} "
                  f"({nbytes} bytes -> {t_bytes:.6f} ms; {compares} "
                  f"compares x 2d = {ops_n} ops -> {t_ops:.6f} ms)")
            if dist == "anticorrelated":
                record["ms"] += t_k
                record["plain_ms"] += t_p
                record["bytes"] += nbytes
                record["ops"] += ops_n
    print(f"peak device memory {torch.cuda.max_memory_allocated()} bytes")

    # -- 6. the kernel record and the device line ----------------------------
    t_bytes = record["bytes"] / MEM_BYTES_PER_S * 1e3
    t_ops = record["ops"] / F32_OPS_PER_S * 1e3
    print(f"{tag} kernel record: launches, ms, plain_ms and bound_ms are "
          f"those of one anticorrelated N={N_MAIN} query (local + merge "
          f"calls); launches per query {launches}")
    print(json.dumps({"kernels": [{
        "name": "sfs_sweep", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches["anticorrelated"],
        "max_abs_err": max_err, "ms": record["ms"],
        "plain_ms": record["plain_ms"], "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu, "count": torch.cuda.device_count()}}))


def count_compares(pts_p, mask_p, block: int, wcap: int) -> int:
    """The dominance compares the sweep needs on these inputs.

    Replays the plain sweep.  A valid candidate needs one compare for
    each live window row up to and including its first dominator (all
    live rows when none dominates it); a candidate that the window does
    not dominate also needs the earlier rows of its block up to and
    including its first dominator there (all of them when none).  The
    main path never calls this."""
    from repro_torch.core.dominance import SENTINEL
    from repro_torch.kernels.sfs.ops import _dominated_by
    p, npad, d = pts_p.shape
    dev = pts_p.device
    window = torch.full((p, wcap + 1, d), SENTINEL, device=dev)
    count = torch.zeros((p,), dtype=torch.int64, device=dev)
    tri = torch.ones((block, block), dtype=torch.bool, device=dev).triu(1)
    rows = torch.arange(block, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    none = torch.iinfo(torch.int64).max
    for b in range(npad // block):
        x = pts_p[:, b * block:(b + 1) * block]
        xm = mask_p[:, b * block:(b + 1) * block]
        live_p = count.clamp(max=wcap)
        live = int(live_p.max())
        first = torch.full((p, block), none, dtype=torch.int64, device=dev)
        for t0 in range(0, live, 4096):
            dom = _dominated_by(window[:, t0:min(t0 + 4096, live)], x)
            idx = dom.to(torch.uint8).argmax(dim=1) + t0
            first = torch.where(dom.any(dim=1) & (first == none), idx, first)
        domw = first != none
        wcmp = torch.where(domw, first + 1, live_p[:, None])
        dom_s = _dominated_by(x, x) & tri
        doms = dom_s.any(dim=1)
        scmp = torch.where(doms, dom_s.to(torch.uint8).argmax(dim=1) + 1,
                           rows)
        total += torch.where(xm, wcmp + torch.where(domw, 0, scmp), 0).sum()
        keep = xm & ~domw & ~doms
        pos = count[:, None] + torch.cumsum(keep, dim=1) - 1
        dest = torch.where(keep & (pos < wcap), pos, wcap)
        window.scatter_(1, dest[..., None].expand(-1, -1, d), x)
        count += keep.sum(dim=1)
    return int(total)


if __name__ == "__main__":
    main()
