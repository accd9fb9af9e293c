#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the skyline system on one NVIDIA GPU.

Run from the root of a checkout, on a host with one CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout
(into build/), one nvcc per source, all started together, then:

  1. prints the card (nvidia-smi name and power limit) and the versions;
  2. prints the build time and the compiler's registers / shared memory /
     spills for each kernel instantiation beside its footprint law (held
     against what the built kernel computes), and checks with
     ``cuobjdump -sass`` that every f32 compare and min/max instruction
     flushes subnormals (.FTZ, from ``--ftz=true``);
  3. holds the SFS sweep kernel against its plain PyTorch version and
     the per-pair oracle, bit for bit, on the card, over ties,
     antichains, overflow, block 2, d 2..12, -0.0, subnormal
     coordinates, f32 score ties between dominating rows, and partitions
     longer than the kernel's prefix (overflow in each of its last
     stage's two branches, an antichain its filter cannot thin, an
     all-masked partition), through the entry and through its three
     grids at prefixes of 0, 1 and 3 blocks; and the dominance kernel
     against its plain version and the O(C x R) oracle over the shapes
     of the JAX package's tests, lower_tri, all-masked refs, d 1..12,
     ties, -0.0, duplicates, subnormals, a batch axis with shared and
     per-batch refs, bf16 input, references past one tile (compacted on
     the card: a long masked tail, masks scattered per batch over shared
     references with an empty batch, R at the small-R threshold and one
     past it, lower_tri over several tiles), and the streaming
     pre-filter's and NoSeq's full shapes, through the entry and through
     its grids; then both kernels on subnormal data (the witness
     (1e-40, 1), (2e-40, 1), (0.5, 0.5), and mixes of subnormals, both
     zeros and normal values at d = 1, 4 and 12, partitions past the
     sweep's prefix, references within one tile and past it) and at
     70,000 partitions (the sweep, stage B running) or batches (the
     dominance test, grid 1 running), more than one grid's y extent;
  4. runs the main path, ``parallel_skyline`` at the default config with
     capacity 65536, on uniform, correlated and anticorrelated data at
     N = 10^7, d = 4: two sweep launches per query, no overflow, and bit
     for bit the plain version's answer on the card; the subnormal
     witness keeps its three members on the card; times what flushing
     adds to the score and the sorts; then, at smaller sizes, the card
     against the CPU on tie-heavy data with -0.0, the member set against
     the O(N^2) oracle, and overflow at the default capacity 4096;
  5. streams the same uniform and anticorrelated data into a live state
     in ten inserts of 10^6 rows, with a snapshot after each: 2 sweep and
     2 dominance launches per insert, every snapshot bit for bit the
     plain version's, the last bit for bit the one-shot answer; traces
     the tenth anticorrelated insert with torch.profiler (the eight
     device operations that took longest, the device's idle share); then
     a batched insert of Q = 4 states against four single ones;
  6. runs ``parallel_skyline`` with ``rep_filter='sorted'`` (2 sweep + 3
     dominance launches) and with ``noseq=True`` (1 + 1) on the three
     distributions: bit for bit the default answer and the plain
     version's, stats included; then the random (p = 8), grid (m = 2,
     p = 16, Grid Filtering on and off) and angular (m = 2, p = 8)
     strategies on the three distributions, once at the default bucket
     factor (grid and angular overflow their skewed buckets, flagged and
     equal to the plain version) and then with buckets sized to the
     largest, under the sequential merge (2 + 0), NoSeq (1 + 1) and the
     tree merge (flat on one device, 2 + 0): bit for bit the plain
     version's and the sliced default answer, with how many angular ids
     the card computes otherwise than the CPU (this and what follows in
     this step run after step 7, so that the kernel times are taken as
     in earlier runs); a sliding window of
     E = 4 epochs fed ten chunks of 10^6 rows, advancing after every
     second and then expired to empty (insert 2 + 2, snapshot 1 + 0 or
     0 + 1 under NoSeq, every snapshot the plain version's and, at each
     advance and expiry, the one-shot answer over the unexpired rows;
     the ring operations under set_sync_debug_mode("error"), the fused
     tick, Q = 4 windows against four single ones); and the default,
     grid and angular queries on the HOU (2,049,280 x 7) and RES
     (3,569,678 x 7) surrogates, bit for bit the plain version's;
  6c. drives the serving layer (``repro_torch.serve``), after step 7's
     kernel times: E1, 64 ragged requests (N from 2^12 to 2^20, the
     three distributions, one masked) through ``submit_many``, 2 sweep
     launches per N bucket, every answer bit for bit its single
     ``parallel_skyline`` and the plain version's (stats included), the
     batch timed against the 64 single calls (queries/s), the partition
     stage's device operations (counted in a CUDA graph capture) equal
     at Q = 4 and Q = 64 under the sliced, grid and angular strategies
     at 4,096 rows a query, and at Q = 4 and Q = 16 at 2^20 rows, and
     its share of the largest bucket; E1's and E2's ``submit_many`` under
     set_sync_debug_mode("error"); E2, 64 scale and 64
     subspace views of one anticorrelated 10^6 x 4 dataset, one run of
     2 sweep launches each, bit for bit ``parallel_skyline`` of the
     flushed product or the zeroed attributes; E3, grid, angular and
     random through ``submit_many`` with buckets sized to the largest;
     E4, ``admit_many`` and ``member_masks`` over 16 queues of 4,096
     requests, one dominance launch, fronts and admitted indices the
     plain version's; E5, one stream of 256 tenants fed ten waves of
     10^3..10^4 anticorrelated rows each (2 + 2 launches a wave, at
     least two slot promotions, ``feed`` and ``snapshot`` under
     set_sync_debug_mode("error"), every snapshot the plain version's,
     after ``drain()`` the one-shot answer over each history), and a
     wave of two streams through ``_wave_feed`` against serial feeds;
     E6, a windowed stream (q = 64, E = 4) ticked for all tenants, then
     half of them, then expired to empty, every snapshot the one-shot
     answer over the unexpired rows; E7, 1,000 idle streams in one
     arena; with feed, snapshot and tick ms per wave;
  6d. drives the serve loop (``repro_torch.serve.loop.ServeLoop``) and
     donation, after the engine step: checks that
     ``torch.cuda.Event.synchronize`` releases the interpreter lock; S1,
     the reference's ``serving_latency`` schedule (12 bursts of 4
     requests of 1,024 x 4 host rows, exponential gaps of mean 12 ms,
     seed 0, p = 4, capacity 512) replayed at depth 1 and depth 2; S2,
     the same schedule with 48 card-resident requests of 2^20 rows (the
     three distributions) at the default config with capacity 65,536,
     the mean gap set to one measured 4-query wave: for both, p50, p99,
     waves, stage_overlap_s, p99(depth 1) / p99(depth 2), every ticket
     bit for bit the synchronous ``submit_many`` and 2 sweep launches a
     wave; S3, E5's traffic split into two 128-tenant streams fed through
     ``loop.feed`` with one 2^20 query a wave at depth 2 (feeds
     coalesced, a promotion riding a pending record, 2 + 2 launches a
     fused wave, after ``drain()`` every snapshot bit for bit serial
     feeds on a second engine, no stream watched after ``close``); S4,
     admission (past deadlines shed, or answered on ``data[::2]`` under
     ``degrade=True``; overload above ``max_queue`` sheds the oldest
     deadline first); S5, step 5's ten inserts and a 4-epoch window
     with donation on and off (same bits, donated leaves keep their
     ``data_ptr``, insert ms and peak device memory of each mode);
     ``ServeLoop._stage_once`` of an S2 and an S3 wave under
     set_sync_debug_mode("error"); prints the step's run time;
  7. times the queries end to end, their stages, each sweep call and
     each dominance call of the paths above (the kernel, the plain
     version, and the least time the card could take), each sweep
     call's three grids with its prefix count, survivors and branch per
     partition, the anticorrelated local call at other prefixes, and
     each dominance call's two grids with its valid reference rows per
     batch (the strategies, windows and real datasets of step 6 are
     timed where they run, beside the sliced default query on the same
     data);
     runs one pre-filter call under torch.cuda.set_sync_debug_mode
     ("error"), so that a host sync in the entry fails the run;
  V. runs the program verifier (``repro_torch.analysis.verifier``) on
     the card, after the serve step: first which of the census's host
     operations raise under set_sync_debug_mode("error") on this card,
     then every cell of ``repro_torch.launch.cells`` with the CUDA
     kernels, on no mesh (the one-device programs), under
     set_sync_debug_mode("error") and the dispatch census (no host
     round-trip, no collective, Q-independent operation counts,
     slab boundary shapes, in-place state updates, the shared-memory
     laws under the sm_90 cap), captured into a CUDA graph at q and 2q
     (equal kernel nodes) and under the 64 MiB peak-memory budget; one
     line per cell (operations, graph kernel nodes, peak bytes, shared
     memory by family, run time), and both kernels must launch;
  M. drives the multi-device merge (``repro_torch.launch.mesh``), after
     step V: in a world of one rank under NCCL, the flat merge, the tree
     merge, NoSeq under the tree merge and rep_filter='sorted' on the
     three distributions at N = 10^7, d = 4, capacity 65,536, and ten
     streaming inserts of 10^6 rows on the mesh, each bit for bit the
     one-device answer; the verifier's mesh cells on 1 x 1 meshes (sync
     debug mode, CUDA graph capture at q and 2q); then worlds of 2 and 4 ranks sharing
     the card (spawned here; gloo, the ppermute staged through pinned
     host memory), the anticorrelated query under the flat and tree
     merges, sequential and NoSeq, bit for bit the one-device answer,
     with each rank's tree rounds, launches, largest collective against
     4·C·(d+2), the rows the flat all_gather moves and the query time
     (one card shared by W ranks: a check of the schedule, not of
     scaling); on a machine with two or more cards, a NCCL world of one
     rank per card (else a line says it did not run);
  T. runs the kernel autotuner (``repro_torch.kernels.tuning``), after
     step M: ``calibrate_kernels`` at its defaults (d = 4, f32, n =
     16,384, p = 8, blocks 128, 256, 512, repeat 3) with every sweep
     candidate bit for bit ``impl='perpair'`` and the dominance entry the
     oracle's, each block's time and the winner against block 256; the
     table saved under build/ and applied to an engine, and each block as
     a table entry, each engine's N = 10^7 anticorrelated answer bit for
     bit an untuned engine's, with its time;
  L. runs the launch entry points as a user would, in subprocesses: the
     serve entry point under ``python -m repro_torch.launch.env --tuning <table>``
     (streaming windowed admission, the serve loop with a 200 ms SLO, a
     sharded batch on a 1 x 1 NCCL mesh; it must report the tuned
     geometries; then yi-6b whole, its prefill and greedy decode of 4
     prompts x 16 tokens: "[serve] generated (4, 16)"), then the skyline
     dry run at full cell sizes on a world of one (every cell ok), with
     each cell's peak bytes;
  P. runs ``pareto_mask`` and ``pareto_select`` (``repro_torch.data.
     selection``) on 131,072 examples x 3 criteria from
     ``example_criteria``, one dominance launch each, bit for bit the
     same calls with impl='torch', and their times;
  G. runs the language models (``repro_torch.models``) on the card,
     after step P: G1, the ten smoke configs on the card against the port
     on the CPU from the same numpy parameters (forward, prefill, one
     decode step), f32 compute at 1e-4 (TF32 off), bf16 with the CPU's
     routing replayed, |card - CPU| at most |CPU bf16 - CPU f32|; G2,
     yi-6b at full width with 2 layers, card against CPU in f32 at 1e-3;
     G3, yi-6b whole (32 layers, 23.19 GB f32): ``generate`` in bf16 at
     batch 4, prompt 32, 16 new tokens: prefill ms, decode ms a step,
     tok/s, peak device memory, and the decode bound (the parameters'
     bytes read once a step), then the reference's prefill/decode
     consistency check in f32 (3e-2 / 4e-2) with q and k rescaled to
     the fan-in of their contraction (with the reference's init, whose
     attention is nearly an argmax at this width, the error is printed
     and not checked); G4, mixtral-8x7b at
     full width with 2 layers, the consistency check at drop-free
     capacity.  No kernel of the port runs here: the models' products
     and attention are plain torch, as the reference's are plain XLA;
  R. trains (``repro_torch.train``, ``repro_torch.launch.train``), after
     step G, with TF32 off: R1, the ten smoke configs, one gradient and
     one ``make_train_step`` with two microbatches each, on the card
     against the port on the CPU from the same numpy parameters and
     batch: f32 gradients and parameters after the step within 2e-3 of
     each leaf's norm (the elements whose update differs by more than
     1e-6 counted: Adam's first update is sign-like where a gradient is
     near zero), bf16 gradients and updates
     per leaf within the CPU's own bf16 error (|card - CPU| at most
     max(|CPU bf16 - CPU f32|, 1e-3 |f32|)), MoE routing replayed; R2,
     yi-6b at its published widths with 2 layers, f32 gradients card
     against CPU within 1e-2 of each leaf's norm (near-argmax attention
     at this width, see G3); R3, ``train_loop`` at
     yi-6b's published widths cut to 8 of 32 layers (bf16 compute, f32
     parameters and moments, remat, 8 microbatches, batch 8 x 4,096), 4
     steps (cut from 6 to keep step R near two minutes): ms a step by
     CUDA events, tokens/s, the model's FLOPs a step over 989.4 TFLOP/s
     dense bf16, peak device memory, losses finite and parameters moved,
     no kernel launched, the last step traced (device idle share); then
     a run to step 2 that writes its checkpoint (19.8 GB) and a restart
     from it to step 4 whose state is the straight run's bit for bit;
     R4, ``python
     -m repro_torch.launch.train --arch yi-6b --smoke --steps 20
     --ckpt-every 5 --fail-at 7`` in a subprocess (the restore line, a
     finite last loss); R5, ``gpipe_forward`` against the sequential
     layers on a NCCL world of one and on worlds of 2 and 4 ranks sharing
     the card through gloo.  No kernel of the port runs in a training
     step;
  8. prints the script's run time, one JSON line with both kernels, then
     the device line.

With ``--kernels-only`` it stops after step 3 and prints no result;
with ``--engine-only`` (``--serve-only``, ``--verify-only``,
``--mesh-only``, ``--tuning-only``, ``--lm-only``, ``--train-only``) it
runs the build and then the engine step 6c (the serve step 6d, step V,
step M, steps T, L and P, step G, step R) alone, and prints no result
either.
Steps 5 and 6 run the default config, so inserts and ring operations
write their state in place; each timed or traced rerun works on a fresh
copy of the state it starts from.  Step 6d holds donation on against
off.
Every check that fails ends the run with a non-zero exit code.  The
script needs a CUDA card; without one, or outside a checkout of the
repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_MAIN = 10_000_000
D_MAIN = 4
MEM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
CHUNK = 1_000_000              # rows per streaming insert
SOURCE = "src/repro_torch/kernels/sfs/csrc/sfs_sweep.cu"
REPLACES = ("src/repro/kernels/sfs/kernel.py:272, "
            "src/repro/kernels/sfs/gpu.py:95")
DOM_SOURCE = "src/repro_torch/kernels/dominance/csrc/dominated_mask.cu"
DOM_REPLACES = ("src/repro/kernels/dominance/kernel.py:118, "
                "src/repro/kernels/dominance/gpu.py:83")


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
    """Largest |difference| between two outputs (0.0 when the bits
    agree)."""
    return float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0


def stats_equal(got: dict, want: dict) -> bool:
    return (list(got) == list(want)
            and all(bits_equal(got[k], want[k]) for k in want))


class Launches:
    """The launch counts of both kernels over one run of a path: set to
    0 when the run starts and read when it ends."""

    def __init__(self, *kernels):
        self.kernels = kernels
        self.counts = None

    def __enter__(self):
        for k in self.kernels:
            k.launches = 0
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.counts = tuple(k.launches for k in self.kernels)


def time_ms(fn, reps: int = 3, fresh=None):
    """Best of ``reps`` timed calls after one warm-up, by CUDA events.
    With ``fresh``, each call is ``fn(fresh())``, the argument made
    before the start event (a copy of a state that a donated call
    writes in place)."""
    call = fn if fresh is None else (lambda: fn(fresh()))
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        arg = () if fresh is None else (fresh(),)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*arg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return min(times), times


def ptxas_report(log: str) -> dict:
    """Registers, static shared memory and spills per (kernel, D)
    instantiation, from the compiler's ``-Xptxas -v`` report."""
    entry = None
    props = {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            km = re.search(r"([a-z_]+_kernel)ILi(\d+)E((?:Lb[01]E)*)",
                           m.group(1))
            entry = None
            if km:
                name = km.group(1)
                flags = re.findall(r"Lb([01])E", km.group(3))
                if name == "dominance_walk_kernel":   # <D, lower_tri, ring>
                    name += (f"<{'ring' if flags[1] == '1' else 'direct'}"
                             f"{', lower_tri' if flags[0] == '1' else ''}>")
                entry = (name, int(km.group(2)))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry is not None:
            props.setdefault(entry, {})["spills"] = (
                f"{m.group(1)} B spill stores, {m.group(2)} B spill loads")
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            sm = re.search(r"(\d+) bytes smem", line)
            props.setdefault(entry, {})["used"] = (
                f"{m.group(1)} registers, {sm.group(1) if sm else 0} B "
                f"static shared memory")
    return props


def smem_law(kernel, name: str, d: int) -> str:
    """The footprint law of one sweep grid at D = d, held against what the
    built kernel computes for its launches."""
    parts = []
    for block in (256, kernel.MAX_BLOCK):
        law = kernel.sweep_smem_bytes(d, block)
        built = kernel.kernel_smem_bytes(d, block, 2 ** 31 - 1)
        check(law == built, f"footprint law {law} differs from the kernel's "
              f"{built} at d={d} block={block}")
        check(max(law.values()) <= kernel.SMEM_LIMIT,
              f"d={d} block={block}: {law} above {kernel.SMEM_LIMIT}")
        stage = "filter" if "filter" in name else "prefix"
        parts.append(f"{law[stage]} B at block {block}")
    return (f"law {', '.join(parts)} of dynamic shared memory (the kernel "
            f"computes the same)")


def dom_smem_law(dkernel, name: str, d: int) -> str:
    """The footprint law of one dominance walk form at D = d, held
    against what the built kernel computes for its launches."""
    if "compact" in name:
        return "; static shared memory only (its scan's warp totals)"
    form = "ring" if "ring" in name else "direct"
    law = dkernel.dominance_smem_bytes(d)[form]
    built = dkernel.kernel_smem_bytes(d)[form]
    check(law == built, f"dominance footprint law {law} differs from the "
          f"kernel's {built} at d={d}, {form} form")
    check(law <= dkernel.SMEM_LIMIT,
          f"d={d} {form} form: {law} above {dkernel.SMEM_LIMIT}")
    what = "the head and two tiles" if form == "ring" else "at most one tile"
    return (f"; law {law} B of dynamic shared memory ({what} of "
            f"{dkernel.tile_rows(d)} rows; the kernel computes the same)")


def case_data(dev, kind, p, n, d, seed):
    """Points and mask of one sweep kernel case, made on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def simplex():                 # an antichain: every valid row is kept
        x = rand(p, n, d) + 1e-3
        return x / x.sum(-1, keepdim=True)

    if kind == "ties":
        x = torch.randint(0, 5, (p, n, d), generator=g, device=dev) / 5
    elif kind == "simplex":
        x = simplex()
    elif kind == "negzero":
        x = torch.tensor([[[-0.0, 0.5], [0.25, 0.25], [0.5, -0.0],
                           [0.75, -1.0], [1.0, 1.0], [0.125, 0.625]]],
                         device=dev).expand(p, n, d).contiguous()
    elif kind == "scoretie":       # f32 scores tie between dominating rows
        x = torch.randint(0, 6, (p, n, d), generator=g, device=dev).float()
        x[..., 0] += 1e8
    elif kind == "mixed":          # partition 0 an antichain, the rest not
        x = rand(p, n, d)
        x[0] = simplex()[0]
    elif kind in ("uniform", "masked"):
        x = rand(p, n, d)
    else:                          # subnormal and zero coordinates
        x = torch.randint(0, 4, (p, n, d), generator=g, device=dev) * 1e-40
        x[rand(p, n, d) < 0.2] = -0.0
    mask = rand(p, n) > 0.1
    if kind == "negzero":
        mask[:] = True
    if kind == "masked":
        mask[p // 2] = False
    return x.float(), mask


SWEEP_CASES = [  # kind, P, n, d, capacity, block
    ("ties", 8, 1000, 4, 1000, 256),
    ("simplex", 8, 2000, 4, 64, 32),       # capacity << n: overflow
    ("simplex", 1, 3000, 7, 4096, 512),
    ("simplex", 8, 120, 2, 48, 2),         # block 2
    ("ties", 1, 200, 2, 256, 2),
    ("simplex", 8, 600, 12, 640, 32),      # d 12
    ("negzero", 1, 6, 2, 6, 2),
    ("denormal", 2, 400, 3, 512, 32),
    # past the prefix of 4096 rows, so that stages B and C run
    ("scoretie", 2, 6000, 3, 6000, 256),
    ("simplex", 8, 6000, 4, 64, 32),       # overflow: C keeps the blocks
    ("mixed", 8, 6000, 4, 512, 256),       # partition 0 overflows, 1-7 pack
    ("simplex", 2, 6000, 4, 8192, 256),    # an antichain: B drops nothing
    ("masked", 8, 6000, 4, 6000, 256),     # partition 4 all masked
    ("uniform", 4, 3000, 4, 3000, 256),    # K x block >= npad: A only
]


def sweep_cases(dev) -> float:
    """The sweep kernel against its plain version and the per-pair
    oracle, bit for bit, through the entry and through its stages at
    prefixes of 0, 1 and 3 blocks; checks which branch stage C takes.
    Returns the largest |difference| between kernel and plain
    outputs."""
    from repro_torch.core import sfs
    from repro_torch.core.dominance import SENTINEL
    from repro_torch.kernels.sfs import kernel, ops
    err = 0.0
    for i, (kind, p, n, d, cap, blk) in enumerate(SWEEP_CASES):
        x, mask = case_data(dev, kind, p, n, d, seed=i)
        pts_p, mask_p, blk_e, wcap = sfs.sweep_inputs(x, mask, capacity=cap,
                                                      block=blk)
        kw = dict(block=blk_e, wcap=wcap, sentinel=SENTINEL)
        name = (f"{kind} P={p} n={n} d={d} capacity={cap} block={blk}")
        got = ops.sfs_sweep(pts_p, mask_p, spec="cuda", **kw)
        torch.cuda.synchronize()
        want = ops.sfs_sweep(pts_p, mask_p, spec="torch", **kw)
        oracle = ops.sfs_sweep(pts_p, mask_p, spec="perpair", **kw)
        err = max(err, abs_err(got[0], want[0]))
        check(leaves_equal(got, want),
              f"kernel differs from the plain version on case {name}")
        check(leaves_equal(want, oracle),
              f"plain version differs from perpair on case {name}")
        if kind == "negzero":
            check(bool(torch.signbit(got[0][got[1]]).any()),
                  "-0.0 member lost its sign")
        staged, info = kernel.sweep_stages(pts_p, mask_p, **kw)
        check(leaves_equal(staged, want), f"the timed stages differ from "
              f"the plain version on case {name}")
        for pre in (0, blk_e, 3 * blk_e):
            out, pinfo = kernel.sweep_stages(pts_p, mask_p, prefix=pre, **kw)
            check(leaves_equal(out, want), f"the kernel with a prefix of "
                  f"{pre} rows differs from the plain version on case {name}")
        tail = mask_p[:, info["prefix_rows"]:].sum(1).tolist()
        branch = info["packed"]
        if n > 4096:
            check(None not in branch, f"{name}: stages B and C did not run")
        if kind == "simplex" and cap < n:
            check(not any(branch), f"{name}: C packed under overflow")
        if kind == "mixed":
            check(branch == [False] + [True] * (p - 1),
                  f"{name}: branches {branch}")
        if kind == "simplex" and n > 4096:
            check(info["survivors"] == tail,
                  f"{name}: B dropped rows of an antichain")
        if kind == "masked":
            check(info["c_a"][p // 2] == 0
                  and info["survivors"][p // 2] == 0,
                  f"{name}: the all-masked partition kept rows")
        if kind == "uniform":
            check(branch == [None] * p, f"{name}: B or C ran")
        print(f"kernel case {name}: bitwise equal to the plain version and "
              f"perpair, also at prefixes 0, {blk_e} and {3 * blk_e} rows "
              f"(counts {got[2].tolist()}; prefix {info['prefix_rows']} "
              f"rows, c_A {info['c_a']}, survivors {info['survivors']}, "
              f"C packed {branch})")
    return err


DOM_SHAPES = [(1, 1, 2), (7, 3, 2), (64, 64, 4), (130, 513, 5), (300, 40, 7),
              (512, 512, 8), (1000, 257, 3)]   # tests/test_dominance_kernel.py


def dominance_cases(dev) -> float:
    """The dominance kernel against its plain version and, where the
    (R, C) matrix is small, the oracle, bit for bit.  Returns the largest
    |difference| between kernel and plain outputs."""
    from repro_torch.kernels.dominance import kernel as dkernel
    from repro_torch.kernels.dominance import ops as dops
    from repro_torch.kernels.dominance.ref import dominated_mask_ref
    g = torch.Generator(device=dev).manual_seed(77)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def pts(kind, *shape):
        if kind == "uniform":
            return rand(*shape)
        x = torch.randint(0, 4, shape, generator=g, device=dev).float()
        x = x / 4 if kind == "ties" else x * 1e-40     # else subnormals
        x[rand(*shape) < 0.15] = -0.0
        return x

    cases = [(f"shape C={c} R={r} d={d}", pts("uniform", c, d),
              pts("uniform", r, d), rand(r) > 0.25, False)
             for c, r, d in DOM_SHAPES]
    x = pts("uniform", 200, 4)
    cases.append(("lower_tri C=R=200 d=4", x, x, None, True))
    cases.append(("all refs masked", pts("uniform", 50, 3),
                  torch.zeros((20, 3), device=dev),
                  torch.zeros(20, dtype=torch.bool, device=dev), False))
    for d in range(2, 13):
        x = pts("ties", 700, d)
        cases.append((f"ties d={d}", x, pts("ties", 900, d), rand(900) > 0.3,
                      False))
        cases.append((f"ties lower_tri d={d}", x, x, rand(700) > 0.3, True))
    z = torch.tensor([[-0.0, 1.0], [0.0, 1.0], [0.0, 0.5]], device=dev)
    cases.append(("signed zeros", z, z, None, False))
    x = pts("ties", 3000, 3)
    cases.append(("ties and -0.0 lower_tri", x, x, rand(3000) > 0.2, True))
    x = pts("subnormal", 2000, 3)
    cases.append(("subnormals", x, pts("subnormal", 1500, 3),
                  rand(1500) > 0.2, False))
    cases.append(("subnormals lower_tri", x, x, None, True))
    # continuous data, so that every batch's flags depend on its refs
    x = pts("uniform", 4, 2000, 4)
    r = pts("uniform", 300, 4)
    cases.append(("B=4 broadcast refs (stride 0), per-batch mask", x,
                  r.expand(4, 300, 4), rand(4, 300) > 0.5, False))
    cases.append(("B=4 broadcast refs and mask", x, r.expand(4, 300, 4),
                  (rand(300) > 0.5).expand(4, 300), False))
    cases.append(("B=4 per-batch refs", x, pts("uniform", 4, 300, 4),
                  rand(4, 300) > 0.5, False))
    cases.append(("B=4 lower_tri", x, x, rand(4, 2000) > 0.3, True))
    x = pts("uniform", 1000, 4).bfloat16()
    cases.append(("bf16", x, pts("uniform", 600, 4).bfloat16(),
                  rand(600) > 0.3, False))
    cases.append(("bf16 lower_tri", x, x, None, True))
    big = torch.zeros(70_000, dtype=torch.bool, device=dev)
    big[:3000] = True           # a compacted state: a masked tail
    cases.append(("C=100000 R=70000, 3000 valid refs first",
                  pts("uniform", 100_000, 4), pts("uniform", 70_000, 4), big,
                  False))

    def antichain(*shape):      # rows on a simplex: no row dominates one
        x = rand(*shape) + 1e-3
        return x / x.sum(-1, keepdim=True)

    # references past one tile, compacted on the card by grid 1
    for d in range(1, 13):
        x = pts("ties", 3000, d)
        refs = torch.cat([pts("ties", 4500, d), x[:500]])   # duplicates
        cases.append((f"compacted ties, -0.0 and duplicates d={d}", x, refs,
                      rand(5000) > 0.3, False))
        xl = pts("ties", 5000, d)
        cases.append((f"compacted ties lower_tri d={d}", xl, xl,
                      rand(5000) > 0.3, True))
    for d in (1, 4, 12):        # R at the small-R threshold and one past
        t = dkernel.tile_rows(d)
        for r in (t, t + 1):
            cases.append((f"R={r} (tile {t} rows) d={d}",
                          pts("ties", 2, 2000, d), pts("ties", 2, r, d),
                          rand(2, r) > 0.4, False))
    x = pts("uniform", 2, 6000, 4)
    cases.append(("lower_tri over six tiles, scattered masks B=2", x, x,
                  rand(2, 6000) > 0.5, True))
    m = rand(3, 5000) > 0.5
    m[1] = False
    cases.append(("B=3 compacted, batch 1 all masked", pts("ties", 3, 2000, 4),
                  pts("ties", 3, 5000, 4), m, False))
    r = pts("uniform", 5000, 4)
    cases.append(("B=4 compacted broadcast refs and mask",
                  pts("uniform", 4, 3000, 4), r.expand(4, 5000, 4),
                  (rand(5000) > 0.7).expand(4, 5000), False))
    # the streaming pre-filter's shape: 10^6 candidates against a state
    # of 65,536 rows whose first 4,000 are valid (an antichain)
    state = pts("uniform", 65_536, 4)
    state[:4000] = antichain(4000, 4) * 2
    live = torch.zeros(65_536, dtype=torch.bool, device=dev)
    live[:4000] = True
    cases.append(("pre-filter shape C=10^6 R=65536, 4000 valid refs first",
                  pts("uniform", 1_000_000, 4), state, live, False))
    # NoSeq's shape: B = 8 partitions of mostly sentinel rows against one
    # shared union, each batch's mask its potential dominators (the
    # union's rows from earlier partitions); batch 0 has none
    union = antichain(65_536, 4) * 2
    parts = torch.randint(0, 8, (65_536,), generator=g, device=dev)
    pd = (parts[None, :] < torch.arange(8, device=dev)[:, None]) \
        & (torch.arange(65_536, device=dev) < 12_000)[None]
    local = torch.full((8, 200_000, 4), 1.7e38, device=dev)
    local[:, :3000] = antichain(8, 3000, 4) * 2
    cases.append(("NoSeq shape B=8 C=200000 R=65536 shared refs, batch 0 "
                  "with no potential dominator", local,
                  union.expand(8, 65_536, 4), pd, False))

    err = 0.0
    for name, c, r, m, lt in cases:
        got = dops.dominated_mask(c, r, m, lower_tri=lt, impl="cuda")
        torch.cuda.synchronize()
        want = dops.dominated_mask(c, r, m, lower_tri=lt, impl="torch")
        err = max(err, abs_err(got.int(), want.int()))
        check(bits_equal(got, want),
              f"dominance kernel differs from the plain version: {name}")
        if c.dtype == torch.float32:
            cb, rb = (c, r) if c.ndim == 3 else (c[None], r[None])
            mb = (torch.ones(rb.shape[-2], dtype=torch.bool, device=dev)
                  if m is None else m)
            mb = mb.expand(cb.shape[0], rb.shape[-2])
            rb = rb.expand(cb.shape[0], -1, -1)
            staged, info = dkernel.dominance_stages(
                cb.contiguous(), rb, mb, lower_tri=lt)
            check(bits_equal(staged.reshape(got.shape), got),
                  f"dominance grids differ from the entry: {name}")
            check(info["compacted"] == dkernel.compacts(rb.shape[1],
                                                        rb.shape[2]),
                  f"{name}: grid 1 ran {info['compacted']}")
            if "NoSeq" in name:
                check(info["valid_rows"][0] == 0
                      and info["valid_rows"][1:] == pd.sum(1)[1:].tolist(),
                      f"{name}: valid rows per batch {info['valid_rows']}")
        oracle = "plain version"
        if r.shape[-2] * (c.numel() // c.shape[-1]) <= 5 * 10 ** 7:
            cb, rb = (c, r) if c.ndim == 3 else (c[None], r[None])
            mb = (torch.ones(rb.shape[:2], dtype=torch.bool, device=dev)
                  if m is None else m if m.ndim == 2 else m[None])
            rb, mb = rb.expand(cb.shape[0], -1, -1), mb.expand(
                cb.shape[0], -1)
            ref = torch.stack([dominated_mask_ref(ci, ri, mi, lower_tri=lt)
                               for ci, ri, mi in zip(cb, rb, mb)])
            check(bits_equal(got.reshape(ref.shape), ref),
                  f"dominance kernel differs from the oracle: {name}")
            oracle = "plain version and oracle"
        print(f"dominance kernel case {name}: bitwise equal to the {oracle} "
              f"({int(got.sum())} of {got.numel()} dominated)")
    check(not bool(dops.dominated_mask(z[:2], z[:2], impl="cuda").any()),
          "-0.0 and +0.0 rows dominate each other on the card")
    return err


def sass_ftz_report(libs) -> str:
    """The f32 compare and min/max instructions of each built library
    (``cuobjdump -sass``): with ``--ftz=true`` every one carries .FTZ,
    so a subnormal operand compares as a zero of its sign."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    parts = []
    for name, path in sorted(libs.items()):
        out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                             text=True, timeout=300)
        check(out.returncode == 0, f"cuobjdump failed on {path}: "
              f"{out.stderr[-2000:]}")
        ops = re.findall(r"\b(FSETP|FMNMX)(\.[A-Z0-9.]+)?", out.stdout)
        bare = [op + suffix for op, suffix in ops if ".FTZ" not in suffix]
        check(ops and not bare, f"{name}: {len(ops)} f32 compare/min/max "
              f"instructions, {len(bare)} without .FTZ: {bare[:8]}")
        parts.append(f"{name} {len(ops)}")
    return ("every f32 compare and min/max instruction carries .FTZ "
            f"(cuobjdump -sass: {', '.join(parts)})")


def subnormal_mix(dev, shape, seed):
    """Coordinates drawn from subnormals of both signs and several
    magnitudes, both zeros and a few normal levels, on the card."""
    levels = torch.tensor([1e-45, 1e-42, 3e-40, 1e-39, 1.1e-38, -1e-45,
                           -2e-40, 0.0, -0.0, 0.25, 0.5, 0.75, 1.0],
                          device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    return levels[torch.randint(0, len(levels), shape, generator=g,
                                device=dev)]


WITNESS = ((1e-40, 1.0), (2e-40, 1.0), (0.5, 0.5))


def subnormal_cases(dev) -> float:
    """Both kernels on subnormal data against their plain versions, bit
    for bit: the witness, and subnormal mixes at d = 1, 4 and 12, the
    sweep over partitions longer than its prefix and through its grids
    at several prefixes, the dominance test with references within one
    tile and past it (compacted) and through its grids.  Returns the
    largest |difference|."""
    from repro_torch.core import sfs
    from repro_torch.core.dominance import SENTINEL
    from repro_torch.kernels.dominance import kernel as dkernel
    from repro_torch.kernels.dominance import ops as dops
    from repro_torch.kernels.sfs import kernel, ops
    err = 0.0
    w = torch.tensor(WITNESS, device=dev)
    sweeps = [("witness", w[None], torch.ones((1, 3), dtype=torch.bool,
                                              device=dev), 3, 2)]
    doms = [("witness", w, w, None, False)]
    for d in (1, 4, 12):
        x = subnormal_mix(dev, (2, 6000, d), seed=d)
        m = subnormal_mix(dev, (2, 6000), seed=100 + d) != 0.25
        sweeps.append((f"subnormal mix d={d}", x, m, 6000, 256))
        t = dkernel.tile_rows(d)
        c = subnormal_mix(dev, (2, 3000, d), seed=200 + d)
        for r in (t // 2, t + 500):
            refs = subnormal_mix(dev, (2, r, d), seed=300 + d + r)
            rm = subnormal_mix(dev, (2, r), seed=400 + d + r) != 0.5
            doms.append((f"subnormal mix d={d} R={r} (tile {t})", c, refs,
                         rm, False))
        doms.append((f"subnormal mix d={d} lower_tri R=C=3000", c, c, None,
                     True))
    for name, x, m, cap, blk in sweeps:
        pts_p, mask_p, blk_e, wcap = sfs.sweep_inputs(x, m, capacity=cap,
                                                      block=blk)
        kw = dict(block=blk_e, wcap=wcap, sentinel=SENTINEL)
        got = ops.sfs_sweep(pts_p, mask_p, spec="cuda", **kw)
        torch.cuda.synchronize()
        want = ops.sfs_sweep(pts_p, mask_p, spec="torch", **kw)
        err = max(err, abs_err(got[0], want[0]))
        check(leaves_equal(got, want), f"sweep kernel differs from the plain "
              f"version on {name}")
        for pre in (0, blk_e, kernel.PREFIX_ROWS):
            out, info = kernel.sweep_stages(pts_p, mask_p, prefix=pre, **kw)
            check(leaves_equal(out, want), f"sweep grids at a prefix of {pre} "
                  f"rows differ from the plain version on {name}")
        print(f"subnormal sweep case {name} (P={pts_p.shape[0]}, npad="
              f"{pts_p.shape[1]}): bitwise equal to the plain version, also "
              f"through the grids at prefixes 0, {blk_e} and "
              f"{kernel.PREFIX_ROWS} rows (counts {got[2].tolist()})")
    for name, c, r, m, lt in doms:
        got = dops.dominated_mask(c, r, m, lower_tri=lt, impl="cuda")
        torch.cuda.synchronize()
        want = dops.dominated_mask(c, r, m, lower_tri=lt, impl="torch")
        err = max(err, abs_err(got.int(), want.int()))
        check(bits_equal(got, want), f"dominance kernel differs from the "
              f"plain version on {name}")
        cb, rb = (c, r) if c.ndim == 3 else (c[None], r[None])
        mb = (torch.ones(rb.shape[:2], dtype=torch.bool, device=dev)
              if m is None else m if m.ndim == 2 else m[None])
        staged, info = dkernel.dominance_stages(cb.contiguous(), rb, mb,
                                                lower_tri=lt)
        check(bits_equal(staged.reshape(got.shape), got), f"dominance grids "
              f"differ from the entry on {name}")
        print(f"subnormal dominance case {name}: bitwise equal to the plain "
              f"version and through the grids (grid 1 ran: "
              f"{info['compacted']}; {int(got.sum())} of {got.numel()} "
              f"dominated)")
    check(not bool(dops.dominated_mask(w, w, impl="cuda").any()),
          "the witness: a row dominates another on the card")
    return err


def many_parts_cases(dev) -> float:
    """More than 65,535 partitions or batches in one entry call: the
    sweep at P = 70,000 with stage B running (its grid takes them in two
    slices of y), the dominance test at B = 70,000 with references past
    one tile (grid 1 in two slices), each against its plain version, bit
    for bit.  Returns the largest |difference|."""
    from repro_torch.core import sfs
    from repro_torch.core.dominance import SENTINEL
    from repro_torch.kernels.dominance import kernel as dkernel
    from repro_torch.kernels.dominance import ops as dops
    from repro_torch.kernels.sfs import kernel, ops
    g = torch.Generator(device=dev).manual_seed(70)
    # masked rows sort last, so the valid rows must outnumber the prefix
    # for stage B to see any
    p, n, d, blk = 70_000, kernel.PREFIX_ROWS + 512, 2, 32
    x = torch.rand((p, n, d), generator=g, device=dev)
    # every third partition an antichain (its rows on a line): B keeps its
    # rows and it overflows, so the survivors and counts of every slice
    # depend on which partition a grid reads
    line = torch.randint(0, 2 ** 20, (len(range(0, p, 3)), n), generator=g,
                         device=dev) / 2 ** 20          # exact: 1 - t too
    x[::3, :, 0], x[::3, :, 1] = line, 1.0 - line
    m = torch.rand((p, n), generator=g, device=dev) > 0.02
    pts_p, mask_p, blk_e, wcap = sfs.sweep_inputs(x, m, capacity=32,
                                                  block=blk)
    del x, m
    kw = dict(block=blk_e, wcap=wcap, sentinel=SENTINEL)
    got = ops.sfs_sweep(pts_p, mask_p, spec="cuda", **kw)
    torch.cuda.synchronize()
    want = ops.sfs_sweep(pts_p, mask_p, spec="torch", **kw)
    err = abs_err(got[0], want[0])
    check(leaves_equal(got, want), f"sweep kernel differs from the plain "
          f"version at P={p}")
    out, info = kernel.sweep_stages(pts_p, mask_p, **kw)
    tail = mask_p[:, info["prefix_rows"]:].sum(1)
    check(leaves_equal(out, want) and None not in info["packed"]
          and info["survivors"][::3] == tail[::3].tolist()
          and sum(info["survivors"][65_535:]) > 0,
          f"P={p}: the grids differ, stage B did not run or dropped rows of "
          f"an antichain")
    print(f"many-partition sweep case P={p} npad={pts_p.shape[1]} d={d} "
          f"block={blk_e}: bitwise equal to the plain version, stage B over "
          f"{-(-p // 65535)} grid slices of y (survivors "
          f"{sum(info['survivors'])}, counts {int(got[2].min())}-"
          f"{int(got[2].max())})")
    del pts_p, mask_p, got, want, out
    b, c = 70_000, 8
    r = dkernel.tile_rows(d) + 1
    cands = torch.rand((b, c, d), generator=g, device=dev)
    refs = torch.rand((b, r, d), generator=g, device=dev)
    rm = torch.rand((b, r), generator=g, device=dev) > 0.5
    got = dops.dominated_mask(cands, refs, rm, impl="cuda")
    torch.cuda.synchronize()
    want = dops.dominated_mask(cands, refs, rm, impl="torch")
    err = max(err, abs_err(got.int(), want.int()))
    check(bits_equal(got, want), f"dominance kernel differs from the plain "
          f"version at B={b}")
    staged, info = dkernel.dominance_stages(cands, refs, rm)
    check(bits_equal(staged, got) and info["compacted"]
          and info["valid_rows"] == rm.sum(1).tolist(),
          f"B={b}: the grids differ or grid 1 counted other rows")
    print(f"many-batch dominance case B={b} C={c} R={r} d={d}: bitwise equal "
          f"to the plain version; grid 1 over {-(-b // 65535)} slices of y "
          f"counted every batch's valid rows ({int(got.sum())} of "
          f"{got.numel()} dominated)")
    return err


def flush_cost(x, tag):
    """What flushing subnormals adds to the score and to a sort key at
    N = 10^7: the port's ``monotone_score`` and ``stable_argsort`` against
    the same calls without the flush (the previous left-to-right sum and
    the signed-zero-only key), by CUDA events, best of 3."""
    from repro_torch.core import dominance as dom

    def score_unflushed(pts):
        s = torch.zeros(pts.shape[:-1], dtype=pts.dtype, device=pts.device)
        for k in range(pts.shape[-1]):
            s = s + pts[..., k]
        return s

    def argsort_unflushed(v):
        v = torch.where(v == 0, torch.zeros_like(v), v)
        return torch.sort(v, stable=True).indices

    s = dom.monotone_score(x)
    check(bits_equal(s, score_unflushed(x)), "flushing changed a score of "
          "data without subnormals")
    rows = []
    for name, new, old in (
            ("monotone_score", lambda: dom.monotone_score(x),
             lambda: score_unflushed(x)),
            ("stable_argsort of the scores", lambda: dom.stable_argsort(s),
             lambda: argsort_unflushed(s)),
            ("canonical_order", lambda: dom.canonical_order(x), None)):
        t_new, _ = time_ms(new)
        t_old = time_ms(old)[0] if old is not None else None
        rows.append(f"{name} {t_new:.3f} ms" + (
            f" (unflushed {t_old:.3f} ms, +{t_new - t_old:.3f})"
            if t_old is not None else ""))
    print(f"{tag} cost of flushing subnormals, N={x.shape[0]} d={x.shape[1]} "
          f"(anticorrelated): {'; '.join(rows)}")


STRATEGIES = (  # name, config fields
    ("random p=8", dict(strategy="random")),
    ("grid m=2 p=16 grid_filter on", dict(strategy="grid", m=2)),
    ("grid m=2 p=16 grid_filter off", dict(strategy="grid", m=2,
                                           grid_filter=False)),
    ("angular m=2 p=8", dict(strategy="angular", m=2)),
)
MERGES = (  # name, config fields, expected (sweep, dominance) launches
    ("sequential", {}, (2, 0)),
    ("noseq", dict(noseq=True), (1, 1)),
    ("tree", dict(merge="tree"), (2, 0)),
)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def strategies_phase(data, oneshot, cfg, tag, kernels):
    """``parallel_skyline`` under the random, grid (Grid Filtering on and
    off) and angular strategies on every distribution at N = 10^7: once
    at the default bucket factor (grid and angular overflow their skewed
    buckets: the flag must be set and the answer must be the plain
    version's), then with the bucket capacity sized to the largest
    bucket, under the sequential merge, NoSeq and the tree merge (flat on
    one device): launches counted, bit for bit the plain version's (stats
    included) and the sliced default answer, timed with their stages.
    Prints how many angular ids computed on the card differ from the
    same data's ids computed on the CPU."""
    from repro_torch.core import api, parallel, partition

    def gen():
        return torch.Generator(device=dev).manual_seed(7)

    for dist, x in data.items():
        dev = x.device
        mask = torch.ones((x.shape[0],), dtype=torch.bool, device=dev)
        t_def, _ = time_ms(lambda: api.parallel_skyline(x, cfg=cfg))
        print(f"{tag} strategies {dist} N={N_MAIN} d={D_MAIN}: the sliced "
              f"default query {t_def:.3f} ms best of 3 on the same data")
        for sname, fields in STRATEGIES:
            base = dataclasses.replace(cfg, **fields)
            if base.strategy == "random":
                sized = base       # balanced: the default factor fits
            else:
                with Launches(*kernels) as run:
                    buf, stats = api.parallel_skyline(x, cfg=base)
                ref, rstats = api.parallel_skyline(
                    x, cfg=dataclasses.replace(base, impl="torch"))
                counts = stats["bucket_counts"]
                check(bool(stats["bucket_overflow"]) and bool(buf.overflow)
                      and run.counts == (2, 0) and leaves_equal(buf, ref)
                      and stats_equal(stats, rstats),
                      f"{dist} {sname} at the default bucket factor: "
                      f"overflow {bool(stats['bucket_overflow'])}, launches "
                      f"{run.counts}, or the answer differs from "
                      f"impl='torch'")
                dropped = (f", grid filter dropped "
                           f"{int(stats['grid_filter_dropped'])} rows"
                           if "grid_filter_dropped" in stats else "")
                print(f"{tag} {sname} {dist} at the default bucket factor "
                      f"(capacity {stats['bucket_counts'].shape[0]} x "
                      f"{-(-N_MAIN // counts.shape[0]) + 1}): bucket_overflow "
                      f"set, skyline {int(buf.count)}, bitwise equal to "
                      f"impl='torch'; bucket counts {counts.tolist()} "
                      f"(largest share {int(counts.max()) / N_MAIN:.4f})"
                      f"{dropped}")
                sized = dataclasses.replace(
                    base, bucket_capacity=_ceil_to(int(counts.max()),
                                                   cfg.block))
            flat_ref = None
            for mname, mfields, want in MERGES:
                qcfg = dataclasses.replace(sized, **mfields)
                with Launches(*kernels) as run:
                    buf, stats = api.parallel_skyline(x, cfg=qcfg,
                                                      generator=gen())
                check(run.counts == want, f"{dist} {sname} {mname}: launches "
                      f"{run.counts}, expected {want}")
                check(not bool(buf.overflow), f"{dist} {sname} {mname}: "
                      f"overflow")
                check(leaves_equal(buf, oneshot[dist]), f"{dist} {sname} "
                      f"{mname}: the result differs from the sliced default "
                      f"answer")
                if mname == "tree":
                    # the tree merge on one device runs the flat math: its
                    # plain version is the flat plain version
                    ref, rstats = flat_ref
                else:
                    ref, rstats = api.parallel_skyline(
                        x, cfg=dataclasses.replace(qcfg, impl="torch"),
                        generator=gen())
                    if mname == "sequential":
                        flat_ref = ref, rstats
                check(leaves_equal(buf, ref) and stats_equal(stats, rstats),
                      f"{dist} {sname} {mname}: result or stats differ from "
                      f"impl='torch'")
                e2e, runs = time_ms(lambda: api.parallel_skyline(
                    x, cfg=qcfg, generator=gen()))
                t_part, _ = time_ms(lambda: parallel.partition_stage(
                    x, mask, qcfg, gen()))
                buckets, meta, _ = parallel.partition_stage(x, mask, qcfg,
                                                            gen())
                sky, _ = parallel.local_stage(buckets.points, buckets.mask,
                                              qcfg)
                t_local, _ = time_ms(lambda: parallel.local_stage(
                    buckets.points, buckets.mask, qcfg))
                t_merge, _ = time_ms(lambda: parallel.merge_stage(
                    sky, meta, qcfg))
                print(f"{tag} {sname} {mname} {dist} N={N_MAIN} d={D_MAIN} "
                      f"(bucket capacity {qcfg.bucket_capacity or 'default'}"
                      f"): {e2e:.3f} ms best of 3 "
                      f"({', '.join(f'{t:.3f}' for t in runs)}); partition "
                      f"{t_part:.3f} ms, local {t_local:.3f} ms, merge "
                      f"{t_merge:.3f} ms; union {int(stats['union_size'])}, "
                      f"skyline {int(buf.count)}; launches {run.counts}; no "
                      f"overflow, bitwise equal to the sliced default answer "
                      f"and to impl='torch', stats included")
        on_card = partition.angular_part_ids(x, 2)
        on_cpu = partition.angular_part_ids(x.cpu(), 2)
        differ = int((on_card.cpu() != on_cpu).sum())
        print(f"{tag} angular ids m=2 {dist} N={N_MAIN}: {differ} of "
              f"{N_MAIN} ids computed on the card differ from the CPU's")


def windows_phase(data, cfg, tag, kernels):
    """Sliding windows at N = 10^7: uniform and anticorrelated data as ten
    chunks of 10^6 into a window of E = 4 epochs, advancing after every
    second chunk (up to 8 x 10^6 rows live), then expired to empty.
    After each chunk the state, stats and snapshot are bit for bit the
    plain version's and the NoSeq snapshot equals the sequential one; at
    each advance and expiry the snapshot equals the one-shot
    ``parallel_skyline`` over the unexpired rows.  Launches: an insert
    2 + 2, a snapshot 1 + 0 (0 + 1 under NoSeq), a ring operation none.
    One advance and one expiry run under set_sync_debug_mode("error").
    The fused tick is held against the separate calls; Q = 4 windows
    against four single ones."""
    from repro_torch.analysis.verifier import no_sync
    from repro_torch.core import api
    from repro_torch.core import windowed as win
    epochs = 4
    # the default config, so inserts and ring operations write the
    # window in place; each timed rerun works on a fresh copy of the
    # window it starts from, made outside the timed span
    plain = dataclasses.replace(cfg, impl="torch")
    noseq = dataclasses.replace(cfg, noseq=True)

    def oneshot_of(x, live):
        rows = torch.cat([x[j * CHUNK:(j + 1) * CHUNK]
                          for ep in live for j in ep])
        return api.parallel_skyline(rows, cfg=cfg)[0]

    def snapshots(state, pstate, where):
        with Launches(*kernels) as run:
            snap = win.finalize(state, cfg=cfg)
        with Launches(*kernels) as nrun:
            nsnap = win.finalize(state, cfg=noseq)
        check(run.counts == (1, 0) and nrun.counts == (0, 1),
              f"{where}: snapshot launches {run.counts}, NoSeq "
              f"{nrun.counts}")
        check(leaves_equal(snap, win.finalize(pstate, cfg=plain)),
              f"{where}: the snapshot differs from impl='torch'")
        check(leaves_equal(nsnap, snap), f"{where}: the NoSeq snapshot "
              f"differs from the sequential one")
        return snap

    for dist in ("uniform", "anticorrelated"):
        x = data[dist]
        state = win.init_window_state(cfg, D_MAIN, epochs=epochs)
        pstate = win.init_window_state(plain, D_MAIN, epochs=epochs)
        live = [[]]
        for i in range(N_MAIN // CHUNK):
            chunk = x[i * CHUNK:(i + 1) * CHUNK]
            before = clone_tree(state)
            with Launches(*kernels) as run:
                state, stats = win.insert_chunk(state, chunk, cfg=cfg)
            check(run.counts == (2, 2), f"window {dist} insert {i + 1}: "
                  f"launches {run.counts}, expected (2, 2)")
            pstate, pstats = win.insert_chunk(pstate, chunk, cfg=plain)
            check(leaves_equal(state, pstate) and stats_equal(stats, pstats),
                  f"window {dist} insert {i + 1}: state or stats differ from "
                  f"impl='torch'")
            live[-1].append(i)
            snap = snapshots(state, pstate, f"window {dist} insert {i + 1}")
            t_ins, _ = time_ms(lambda w: win.insert_chunk(w, chunk, cfg=cfg),
                               fresh=lambda: clone_tree(before))
            t_snap, _ = time_ms(lambda: win.finalize(state, cfg=cfg))
            t_nsnap, _ = time_ms(lambda: win.finalize(state, cfg=noseq))
            t_tick, _ = time_ms(lambda w: win.window_tick(w, chunk, cfg=cfg),
                                fresh=lambda: clone_tree(before))
            msg = ""
            if i % 2:
                with Launches(*kernels) as run:
                    state, astats = win.advance_epoch(state)
                check(run.counts == (0, 0), f"advance launched {run.counts}")
                pstate, _ = win.advance_epoch(pstate)
                live.append([])
                if len(live) > epochs:
                    live.pop(0)
                snap = snapshots(state, pstate, f"window {dist} advance")
                check(leaves_equal(snap, oneshot_of(x, live)),
                      f"window {dist} after insert {i + 1}: the snapshot "
                      f"differs from the one-shot answer over the unexpired "
                      f"rows")
                t_adv, _ = time_ms(win.advance_epoch,
                                   fresh=lambda: clone_tree(state))
                msg = (f"; advance {t_adv:.3f} ms (expired "
                       f"{int(astats['expired_tuples'])} retained rows), "
                       f"{sum(len(ep) for ep in live)} chunks live, snapshot "
                       f"bitwise the one-shot answer over them")
            print(f"{tag} window {dist} insert {i + 1}/{N_MAIN // CHUNK} "
                  f"({CHUNK} rows, E={epochs}): insert {t_ins:.3f} ms, "
                  f"snapshot {t_snap:.3f} ms, NoSeq snapshot {t_nsnap:.3f} "
                  f"ms, tick {t_tick:.3f} ms (best of 3); retained "
                  f"{int(state.count.sum())}, front {int(snap.count)}; state, "
                  f"stats and snapshots bitwise equal to impl='torch'{msg}")
        spare = clone_tree(state)
        no_sync(lambda: win.expire_epoch(win.advance_epoch(spare)[0]))
        torch.cuda.synchronize()
        print(f"window {dist}: advance_epoch and expire_epoch under "
              f"torch.cuda.set_sync_debug_mode('error'): no host sync raised")
        while live != [[]]:
            state, estats = win.expire_epoch(state)
            pstate, _ = win.expire_epoch(pstate)
            live = live[1:] if len(live) > 1 else [[]]
            snap = snapshots(state, pstate, f"window {dist} expiry")
            want = (oneshot_of(x, live) if any(live) else None)
            check(want is None and int(snap.count) == 0
                  or want is not None and leaves_equal(snap, want),
                  f"window {dist} expiry: the snapshot differs from the "
                  f"one-shot answer over the unexpired rows")
            print(f"window {dist} expiry: {int(estats['expired_tuples'])} "
                  f"retained rows expired, front {int(snap.count)}, bitwise "
                  f"the one-shot answer over the unexpired rows")
        check(int(state.count.sum()) == 0 and int(state.active) == 1,
              f"window {dist}: not empty after expiring every epoch")
        # the fused tick against the separate calls
        fused, front, _ = win.window_tick(clone_tree(state),
                                          data[dist][:CHUNK], cfg=cfg,
                                          advance=torch.tensor(
                                              True, device=x.device))
        sep, _ = win.advance_epoch(clone_tree(state))
        sep, _ = win.insert_chunk(sep, data[dist][:CHUNK], cfg=cfg)
        check(leaves_equal(fused, sep)
              and leaves_equal(front, win.finalize(sep, cfg=cfg)),
              f"window {dist}: the fused tick differs from the separate "
              f"calls")
        print(f"window {dist}: the fused tick (advance as a tensor) bitwise "
              f"equal to advance + insert + finalize")

    # Q = 4 windows on one ring clock against four single windows
    x = data["anticorrelated"]
    q, rows = 4, N_MAIN // 40
    bstate = win.init_window_state(cfg, D_MAIN, epochs=2, q=q)
    singles = [win.init_window_state(cfg, D_MAIN, epochs=2) for _ in range(q)]
    for i in range(4):
        chunk = x[i * q * rows:(i + 1) * q * rows].reshape(q, rows, D_MAIN)
        with Launches(*kernels) as run:
            bstate, _ = win.insert_chunk(bstate, chunk, cfg=cfg)
        check(run.counts == (2, 2), f"batched window insert {i + 1}: "
              f"launches {run.counts}")
        singles = [win.insert_chunk(s, chunk[j], cfg=cfg)[0]
                   for j, s in enumerate(singles)]
        if i % 2:
            bstate, _ = win.advance_epoch(bstate)
            singles = [win.advance_epoch(s)[0] for s in singles]
        with Launches(*kernels) as run:
            bsnap = win.finalize(bstate, cfg=cfg)
        check(run.counts == (1, 0), f"batched window snapshot: launches "
              f"{run.counts}")
        for j in range(q):
            ring = [getattr(bstate, k)[j] for k in win._EPOCH_LEAVES]
            check(leaves_equal(ring, [getattr(singles[j], k)
                                      for k in win._EPOCH_LEAVES])
                  and leaves_equal(bstate[6:], singles[j][6:])
                  and leaves_equal([leaf[j] for leaf in bsnap],
                                   win.finalize(singles[j], cfg=cfg)),
                  f"batched window {j} differs from its single window")
    t_b, _ = time_ms(lambda: win.finalize(bstate, cfg=cfg))
    print(f"{tag} batched windows Q={q} x {rows} rows a wave, E=2: every ring "
          f"and snapshot bitwise equal to the {q} single windows; batched "
          f"snapshot {t_b:.3f} ms in one sweep launch (fronts "
          f"{bsnap.count.tolist()})")


# -- the batched engine, the slab arena and Pareto admission ------------------

ENGINE_Q = 64                  # requests of the ragged batch (E1)
ENGINE_N_LOG2 = (12, 20)       # their N, log-uniform over 2^12 .. 2^20
VIEW_N = 1_000_000             # rows of the dataset behind the views (E2)
STRAT_Q, STRAT_N = 8, 1 << 18  # strategy requests per batch and rows (E3)
ADMIT_QUEUES, ADMIT_N = 16, 4096  # admission queues and requests (E4)
STREAM_Q, STREAM_WAVES = 256, 10  # stream tenants and waves (E5)
CHUNK_ROWS = (1000, 10000)        # rows per tenant and wave (E5, E6)
WINDOW_Q, WINDOW_E = 64, 4        # windowed tenants and epochs (E6)
IDLE_STREAMS = 1000               # idle single-tenant streams (E7)


def clone_tree(state):
    """A copy of every leaf of a state (a named tuple of tensors)."""
    return type(state)(*(leaf.clone() for leaf in state))


def event_ms(fn):
    """One call of ``fn`` timed by CUDA events (for stateful calls that
    cannot be repeated); returns (result, ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def buffers_equal(got, want) -> bool:
    return leaves_equal(tuple(got), tuple(want))


def member_set(buf) -> set:
    return {tuple(r) for r in
            buf.points[buf.mask].view(torch.int32).tolist()}


def span(ts) -> str:
    return (f"min {min(ts):.3f}, median {sorted(ts)[len(ts) // 2]:.3f}, "
            f"max {max(ts):.3f} ms")


def engine_phase(tag, kernels, dev=torch.device("cuda")) -> None:
    """The serving layer on the card (E1-E7, see the module docstring)."""
    from repro_torch.analysis.verifier import graph_ops, no_sync
    from repro_torch.core import api, datagen, parallel
    from repro_torch.core.dominance import flush_subnormal
    from repro_torch.serve import engine as eng
    from repro_torch.serve import scheduler as sched
    from repro_torch.serve.api import SkylineRequest, StreamOptions
    cfg = parallel.SkyConfig(capacity=65536)
    plain = dataclasses.replace(cfg, impl="torch")
    engine = eng.SkylineEngine(cfg, device=dev)
    pengine = eng.SkylineEngine(plain, device=dev)
    dists = ("uniform", "correlated", "anticorrelated")
    t_phase = time.perf_counter()

    # -- E1: a ragged batch of plain requests --------------------------------
    g = torch.Generator().manual_seed(2024)
    lo, hi = ENGINE_N_LOG2
    sizes = [int(2 ** (lo + (hi - lo) * float(u)))
             for u in torch.rand(ENGINE_Q, generator=g)]
    sizes[0], sizes[1] = 2 ** lo, 2 ** hi
    reqs = []
    for i, n in enumerate(sizes):
        gen = torch.Generator(device=dev).manual_seed(5000 + i)
        x = datagen.generate(dists[i % 3], gen, n, D_MAIN)
        mask = (torch.rand((n,), generator=gen, device=dev) > 0.3
                if i == 5 else None)
        reqs.append(SkylineRequest(data=x, mask=mask))
    buckets = sorted({eng._next_bucket(n, engine.min_n_bucket)
                      for n in sizes})
    check(len(buckets) >= 4, f"E1: only {len(buckets)} N buckets")
    before = engine.batches_dispatched
    with Launches(*kernels) as run:
        out = no_sync(lambda: engine.submit_many(reqs))
    nb_runs = engine.batches_dispatched - before
    check(nb_runs == len(buckets) and run.counts == (2 * nb_runs, 0),
          f"E1: {nb_runs} runs for {len(buckets)} buckets, launches "
          f"{run.counts}, expected {(2 * len(buckets), 0)}")
    pout = pengine.submit_many(reqs)
    for i, (r, (buf, stats), (pbuf, pstats)) in enumerate(
            zip(reqs, out, pout)):
        ref, _ = api.parallel_skyline(r.data, r.mask, cfg=cfg)
        check(not bool(buf.overflow) and buffers_equal(buf, ref),
              f"E1 request {i} (N={sizes[i]}): differs from its single "
              f"parallel_skyline or overflows")
        check(buffers_equal(buf, pbuf) and stats_equal(dict(stats),
                                                       dict(pstats)),
              f"E1 request {i}: differs from impl='torch'")
    t_batch, runs = time_ms(lambda: engine.submit_many(reqs))
    t_single, sruns = time_ms(lambda: [api.parallel_skyline(
        r.data, r.mask, cfg=cfg) for r in reqs])
    per_bucket = {}
    for n in sizes:
        nb = eng._next_bucket(n, engine.min_n_bucket)
        per_bucket[nb] = per_bucket.get(nb, 0) + 1
    print(f"{tag} E1 ragged batch: {ENGINE_Q} requests, N from {min(sizes)} "
          f"to {max(sizes)} ({sum(sizes)} rows; uniform, correlated and "
          f"anticorrelated; one masked), {len(buckets)} N buckets "
          f"{per_bucket}: launches {run.counts} = 2 sweep + 0 dominance per "
          f"bucket, under set_sync_debug_mode('error'); every answer bitwise equal to its single "
          f"parallel_skyline and to impl='torch', stats included")
    print(f"{tag} E1 time: the batch {t_batch:.3f} ms best of 3 "
          f"({', '.join(f'{t:.3f}' for t in runs)}), "
          f"{ENGINE_Q / t_batch * 1e3:.1f} queries/s; the {ENGINE_Q} single "
          f"calls {t_single:.3f} ms ({', '.join(f'{t:.3f}' for t in sruns)}),"
          f" {ENGINE_Q / t_single * 1e3:.1f} queries/s; "
          f"{t_single / t_batch:.3f}x")
    # the partition stage: one bucket's device operations at Q = 4 and 64
    # under each strategy that needs no draw (the random strategy draws
    # once per query), and its share of the bucket's run
    nb = 4096
    xs = datagen.uniform(torch.Generator(device=dev).manual_seed(9),
                         ENGINE_Q * nb, D_MAIN).reshape(ENGINE_Q, nb, D_MAIN)
    ms = torch.ones((ENGINE_Q, nb), dtype=torch.bool, device=dev)
    pcfgs = (("sliced", cfg),
             ("grid m=2", dataclasses.replace(cfg, strategy="grid", m=2)),
             ("angular m=2", dataclasses.replace(cfg, strategy="angular",
                                                 m=2)))
    stage_ops = {}
    for sname, scfg in pcfgs:
        ops4 = graph_ops(lambda: parallel.partition_stage(xs[:4], ms[:4],
                                                          scfg))
        ops64 = graph_ops(lambda: parallel.partition_stage(xs, ms, scfg))
        check(ops4 == ops64, f"E1 {sname}: the partition stage of a bucket "
              f"makes {ops4} device operations at Q=4 and {ops64} at Q=64")
        stage_ops[sname] = ops4
    print(f"{tag} E1 partition stage of one bucket (nb={nb}), device "
          f"operations in a CUDA graph capture, equal at Q=4 and Q=64: "
          + "; ".join(f"{k} {v}" for k, v in stage_ops.items()))
    # and at 2^20 rows a query, where a batched torch.sort would sort row
    # by row (the stage sorts all Q x N keys at once)
    del xs, ms
    nbl = 2 ** ENGINE_N_LOG2[1]
    xl = datagen.uniform(torch.Generator(device=dev).manual_seed(10),
                         16 * nbl, D_MAIN).reshape(16, nbl, D_MAIN)
    ml = torch.ones((16, nbl), dtype=torch.bool, device=dev)
    large = {q: graph_ops(lambda: parallel.partition_stage(xl[:q], ml[:q],
                                                            cfg))
             for q in (4, 16)}
    check(large[4] == large[16], f"E1: the sliced partition stage at "
          f"nb={nbl} makes {large[4]} device operations at Q=4 and "
          f"{large[16]} at Q=16")
    print(f"{tag} E1 partition stage at nb={nbl}, sliced, device operations "
          f"in a CUDA graph capture, equal at Q=4 and Q=16: {large[4]}")
    del xl, ml
    big = max(per_bucket)
    bidx = [i for i, n in enumerate(sizes)
            if eng._next_bucket(n, engine.min_n_bucket) == big]
    qb = engine._q_bucket(len(bidx))
    pts_b, mask_b = engine._pack([reqs[i].data for i in bidx],
                                 [reqs[i].mask for i in bidx],
                                 range(len(bidx)), qb)
    t_part, _ = time_ms(lambda: parallel.partition_stage(pts_b, mask_b, cfg))
    t_run, _ = time_ms(lambda: engine._run(pts_b, mask_b, [0] * qb, cfg))
    print(f"{tag} E1 the "
          f"largest bucket (nb={big}, {len(bidx)} requests, qb={qb}): "
          f"partition {t_part:.3f} ms of the run's {t_run:.3f} ms "
          f"(share {t_part / t_run:.4f})")

    # -- E2: scale and subspace views of one dataset -------------------------
    gen = torch.Generator(device=dev).manual_seed(77)
    base = datagen.anticorrelated(gen, VIEW_N, D_MAIN)
    weights = 0.5 + 1.5 * torch.rand((ENGINE_Q, D_MAIN), generator=gen,
                                     device=dev)
    dims = torch.rand((ENGINE_Q, D_MAIN), generator=gen, device=dev) < 0.6
    dims[:, :2] = torch.rand((ENGINE_Q, 2), generator=gen, device=dev) < 2
    for kind, params in (("scale", weights), ("subspace", dims)):
        vreqs = [SkylineRequest(data=base, **{kind: params[j]})
                 for j in range(ENGINE_Q)]
        before = engine.batches_dispatched
        with Launches(*kernels) as run:
            vout = no_sync(lambda: engine.submit_many(vreqs))
        check(engine.batches_dispatched - before == 1
              and run.counts == (2, 0), f"E2 {kind}: "
              f"{engine.batches_dispatched - before} runs, launches "
              f"{run.counts}, expected one run of (2, 0)")
        for j, (buf, _) in enumerate(vout):
            view = (flush_subnormal(flush_subnormal(base)
                                    * flush_subnormal(params[j]))
                    if kind == "scale"
                    else torch.where(params[j], base, 0.0))
            ref, _ = api.parallel_skyline(view, cfg=cfg)
            check(not bool(buf.overflow) and buffers_equal(buf, ref),
                  f"E2 {kind} view {j}: differs from parallel_skyline of "
                  f"the {'flushed product' if kind == 'scale' else 'zeroed attributes'}")
        t_v, _ = time_ms(lambda: engine.submit_many(vreqs))
        fronts = [int(b.count) for b, _ in vout]
        print(f"{tag} E2 {ENGINE_Q} {kind} views of one anticorrelated "
              f"{VIEW_N} x {D_MAIN} dataset: one run, launches {run.counts} "
              f"under set_sync_debug_mode('error'), "
              f"{t_v:.3f} ms best of 3 ({ENGINE_Q / t_v * 1e3:.1f} views/s); "
              f"fronts {min(fronts)}..{max(fronts)}; every view bitwise "
              f"equal to parallel_skyline of the "
              f"{'flushed f32 product' if kind == 'scale' else 'zeroed attributes'}")
    del base

    # -- E3: the other strategies through submit_many ------------------------
    sreqs = []
    for i in range(STRAT_Q):
        gen = torch.Generator(device=dev).manual_seed(8000 + i)
        sreqs.append(SkylineRequest(
            data=datagen.generate(dists[i % 3], gen, STRAT_N - 17 * i,
                                  D_MAIN), key=300 + i))
    sliced = engine.submit_many(sreqs)
    for sname, fields in (("grid m=2", dict(strategy="grid", m=2)),
                          ("angular m=2", dict(strategy="angular", m=2)),
                          ("random p=8", dict(strategy="random"))):
        scfg = dataclasses.replace(cfg, **fields)
        first = eng.SkylineEngine(scfg, device=dev).submit_many(sreqs)
        largest = max(int(s["bucket_counts"].max()) for _, s in first)
        sized = dataclasses.replace(scfg, bucket_capacity=_ceil_to(
            largest, cfg.block))
        se = eng.SkylineEngine(sized, device=dev)
        with Launches(*kernels) as run:
            sout = se.submit_many(sreqs)
        check(run.counts == (2, 0), f"E3 {sname}: launches {run.counts}")
        pout = eng.SkylineEngine(dataclasses.replace(sized, impl="torch"),
                                 device=dev).submit_many(sreqs)
        for i, ((buf, st), (pbuf, pst), (ref, _)) in enumerate(
                zip(sout, pout, sliced)):
            check(not bool(buf.overflow), f"E3 {sname} request {i}: "
                  f"overflow with buckets sized to the largest")
            if sized.strategy == "random":
                check(member_set(buf) == member_set(ref)
                      and int(buf.count) == int(ref.count),
                      f"E3 {sname} request {i}: the member set or count "
                      f"differs from the sliced answer")
            else:
                single, _ = api.parallel_skyline(sreqs[i].data, cfg=sized)
                check(buffers_equal(buf, single) and buffers_equal(buf, pbuf)
                      and stats_equal(dict(st), dict(pst)),
                      f"E3 {sname} request {i}: differs from its single "
                      f"parallel_skyline or from impl='torch'")
        t_s, _ = time_ms(lambda: se.submit_many(sreqs))
        print(f"{tag} E3 {sname}: {STRAT_Q} requests of about {STRAT_N} rows "
              f"in one bucket, buckets sized to the largest "
              f"({sized.bucket_capacity} rows), launches {run.counts}, "
              f"{t_s:.3f} ms best of 3; "
              + ("member sets and counts equal to the sliced answers"
                 if sized.strategy == "random" else
                 "bitwise equal to the single parallel_skyline and to "
                 "impl='torch', stats included"))

    # -- E4: Pareto admission -------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(44)
    queues = [sched.Request(
        slack=torch.empty(ADMIT_N, device=dev).exponential_(0.1,
                                                            generator=gen),
        neg_priority=-torch.randint(0, 3, (ADMIT_N,), generator=gen,
                                    device=dev).float(),
        cost=torch.randint(8, 64, (ADMIT_N,), generator=gen,
                           device=dev).float())
        for _ in range(ADMIT_QUEUES)]
    with Launches(*kernels) as run:
        adm = sched.admit_many(queues, 64, engine=engine)
    check(run.counts == (0, 1), f"E4 admit_many: launches {run.counts}, "
          f"expected (0, 1)")
    padm = sched.admit_many(queues, 64, engine=pengine)
    for j, ((idx, front), (pidx, pfront)) in enumerate(zip(adm, padm)):
        check(bits_equal(idx, pidx) and bits_equal(front, pfront),
              f"E4 queue {j}: admitted indices or front differ from "
              f"impl='torch'")
    with Launches(*kernels) as run:
        masks = engine.member_masks([sched._criteria(r, dev)
                                     for r in queues])
    check(run.counts == (0, 1), f"E4 member_masks: launches {run.counts}")
    t_a, _ = time_ms(lambda: sched.admit_many(queues, 64, engine=engine))
    print(f"{tag} E4 admission: {ADMIT_QUEUES} queues x {ADMIT_N} requests "
          f"x 3 criteria, one dominance launch (member_masks and admit_many "
          f"alike); fronts {[int(m.sum()) for m in masks]}; fronts and "
          f"admitted indices bitwise equal to impl='torch'; admit_many "
          f"{t_a:.3f} ms best of 3")

    # -- E5: one stream of 256 tenants ---------------------------------------
    gen = torch.Generator(device=dev).manual_seed(55)
    hist = [[] for _ in range(STREAM_Q)]
    s = engine.open_stream(D_MAIN, StreamOptions(q=STREAM_Q, key=1))
    ps = pengine.open_stream(D_MAIN, StreamOptions(q=STREAM_Q, key=1))
    rows_seen = [s.rows]
    t_feed, t_snap = [], []
    for w in range(STREAM_WAVES):
        ns = torch.randint(CHUNK_ROWS[0], CHUNK_ROWS[1] + 1, (STREAM_Q,),
                           generator=g).tolist()
        chunks = [datagen.anticorrelated(gen, n, D_MAIN) for n in ns]
        for t, c in enumerate(chunks):
            hist[t].append(c)
        with Launches(*kernels) as run:
            _, tf = event_ms(lambda: no_sync(lambda: s.feed(chunks)))
        check(run.counts == (2, 2), f"E5 wave {w}: feed launches "
              f"{run.counts}, expected (2, 2)")
        with Launches(*kernels) as run:
            snap, tsn = event_ms(lambda: no_sync(s.snapshot))
        check(run.counts == (0, 0), f"E5 wave {w}: snapshot launches "
              f"{run.counts}")
        rows_seen.append(s.rows)
        t_feed.append(tf)
        t_snap.append(tsn)
        ps.feed(chunks)
        psnap = ps.snapshot()
        check(all(buffers_equal(a, b) for a, b in zip(snap, psnap)),
              f"E5 wave {w}: a snapshot differs from impl='torch'")
    s.drain()
    rows_seen.append(s.rows)
    promotions = sum(a != b for a, b in zip(rows_seen, rows_seen[1:]))
    check(promotions >= 2, f"E5: {promotions} promotions (slot rows "
          f"{rows_seen}), expected at least two")
    final = s.snapshot()
    one = engine.submit_many([SkylineRequest(data=torch.cat(h))
                              for h in hist])
    check(all(buffers_equal(a, b) for a, (b, _) in zip(final, one)),
          "E5: after drain() a tenant's snapshot differs from the one-shot "
          "answer over its history")
    counters = s.counters()
    fronts = [int(b.count) for b in final]
    print(f"{tag} E5 stream: q={STREAM_Q} tenants, {STREAM_WAVES} waves of "
          f"{CHUNK_ROWS[0]}..{CHUNK_ROWS[1]} anticorrelated rows per tenant: "
          f"launches (2, 2) per "
          f"feed and (0, 0) per snapshot; feed and snapshot under "
          f"set_sync_debug_mode('error'); slot rows per wave {rows_seen} "
          f"({promotions} promotions, min_slab_rows "
          f"{engine.min_slab_rows}); fronts "
          f"{min(fronts)}..{max(fronts)}, seen {int(counters['seen'].sum())}; "
          f"every snapshot bitwise equal to impl='torch', and after drain() "
          f"to the one-shot answer over each tenant's history")
    print(f"{tag} E5 per wave (CUDA events, one call each): feed "
          f"{span(t_feed)}; snapshot {span(t_snap)}")
    s.close()
    ps.close()
    # coalescing: a wave of two streams against serial feeds
    a1, a2, b1, b2 = (engine.open_stream(D_MAIN, StreamOptions(q=16, key=k))
                      for k in (3, 4, 3, 4))
    for w in range(3):
        c1 = [datagen.anticorrelated(gen, 3 * CHUNK_ROWS[0], D_MAIN)
              for _ in range(16)]
        c2 = [datagen.uniform(gen, 2 * CHUNK_ROWS[0], D_MAIN)
              for _ in range(16)]
        a1.feed(c1)
        a2.feed(c2)
        with Launches(*kernels) as run:
            no_sync(lambda: eng._wave_feed(engine, [
                (b1, *b1._feed_args(c1, None)),
                (b2, *b2._feed_args(c2, None))]))
        # one wave, or one per rows bucket once a promotion split them
        check(run.counts in ((2, 2), (4, 4)), f"E5 coalesced wave {w}: "
              f"launches {run.counts}")
        for sa, sb in ((a1, b1), (a2, b2)):
            check(all(buffers_equal(x, y) for x, y in
                      zip(sa.snapshot(), sb.snapshot())),
                  f"E5 coalesced wave {w}: differs from serial feeds")
    print(f"{tag} E5 coalescing: three waves of two 16-tenant streams "
          f"through _wave_feed bitwise equal to serial feeds")
    for st in (a1, a2, b1, b2):
        st.close()

    # -- E6: windows ----------------------------------------------------------
    ws = engine.open_stream(D_MAIN, StreamOptions(q=WINDOW_Q,
                                                  window_epochs=WINDOW_E))
    rings = [[[]] for _ in range(WINDOW_Q)]

    def tick_model(sel):
        expired = False
        for t in sel:
            rings[t].append([])
            if len(rings[t]) > WINDOW_E:
                rings[t].pop(0)
                expired = True
        return expired

    def expire_model():
        for r in rings:
            if len(r) > 1:
                r.pop(0)
            else:
                r[0] = []

    def check_window(where):
        with Launches(*kernels) as run:
            snap, tsn = event_ms(lambda: no_sync(ws.snapshot))
        check(run.counts == (1, 0), f"E6 {where}: snapshot launches "
              f"{run.counts}")
        live = [[c for ep in r for c in ep] for r in rings]
        want = engine.submit_many([SkylineRequest(data=torch.cat(c))
                                   for c in live if c])
        it = iter(want)
        for t, (buf, c) in enumerate(zip(snap, live)):
            if c:
                ok = buffers_equal(buf, next(it)[0])
            else:
                ok = int(buf.count) == 0 and not bool(buf.mask.any())
            check(ok, f"E6 {where} tenant {t}: the snapshot differs from "
                  f"the one-shot answer over the unexpired rows")
        return tsn

    t_wfeed, t_wsnap, t_tick = [], [], []
    for w in range(8):
        ns = torch.randint(CHUNK_ROWS[0], CHUNK_ROWS[1] + 1, (WINDOW_Q,),
                           generator=g).tolist()
        chunks = [datagen.anticorrelated(gen, n, D_MAIN) for n in ns]
        for r, c in zip(rings, chunks):
            r[-1].append(c)
        with Launches(*kernels) as run:
            _, tf = event_ms(lambda: no_sync(lambda: ws.feed(chunks)))
        check(run.counts == (2, 2), f"E6 wave {w}: feed launches "
              f"{run.counts}")
        t_wfeed.append(tf)
        t_wsnap.append(check_window(f"wave {w}"))
        if w % 2:
            sel = list(range(WINDOW_Q)) if w < 6 else \
                list(range(0, WINDOW_Q, 2))
            with Launches(*kernels) as run:
                got, tt = event_ms(lambda: no_sync(
                    lambda: ws.tick(None if len(sel) == WINDOW_Q else sel)))
            check(run.counts == (0, 0) and got == tick_model(sel),
                  f"E6 tick after wave {w}: launches {run.counts}, expired "
                  f"{got}")
            t_tick.append(tt)
            check_window(f"tick after wave {w}")
    ws.drain()
    for k in range(WINDOW_E):
        ws.expire_epoch()
        expire_model()
        check_window(f"expiry {k}")
    check(all(int(b.count) == 0 for b in ws.snapshot()),
          "E6: the windows are not empty after expiring every epoch")
    print(f"{tag} E6 windows: q={WINDOW_Q}, E={WINDOW_E}, 8 waves of "
          f"{CHUNK_ROWS[0]}..{CHUNK_ROWS[1]} anticorrelated rows per tenant, "
          f"ticking all tenants "
          f"after every second wave, then half of them, then expired to "
          f"empty: feed (2, 2), snapshot (1, 0), tick (0, 0) launches, all "
          f"under set_sync_debug_mode('error'); every snapshot bitwise the "
          f"one-shot answer over the unexpired rows")
    print(f"{tag} E6 per wave (CUDA events, one call each): feed "
          f"{span(t_wfeed)}; snapshot {span(t_wsnap)}; tick {span(t_tick)}")
    ws.close()

    # -- E7: an idle fleet -----------------------------------------------------
    fleet = eng.SkylineEngine(cfg, device=dev)
    streams = [fleet.open_stream(D_MAIN, StreamOptions(q=1))
               for _ in range(IDLE_STREAMS)]
    report = fleet.arena_report()
    check(len(report) == 1, f"E7: {len(report)} arenas for one bucket")
    (key, rep), = report.items()
    for st in streams:
        st.close()
    after = fleet.arena_report()[key]
    check(after["leased"] == 0, f"E7: {after['leased']} slots still leased")
    print(f"{tag} E7 idle fleet: {IDLE_STREAMS} single-tenant streams in one "
          f"arena {key}: {rep['slots']} slots, {rep['buffers']} device "
          f"tensors, {rep['bytes']} bytes, {rep['grows']} growths; after "
          f"closing {after['slots'] - after['leased']} free slots of "
          f"{after['slots']}")
    print(f"{tag} engine step ran {time.perf_counter() - t_phase:.3f} s; "
          f"peak device memory so far {torch.cuda.max_memory_allocated()} "
          f"bytes")


# -- the serve loop and donation ------------------------------------------------

SERVE_BURSTS, SERVE_WIDTH = 12, 4    # bursts of requests (S1, S2)
SERVE_N, SERVE_GAP_MS = 1024, 12.0   # S1: serving_latency's defaults
SERVE_BIG_N = 1 << 20                # rows of an S2 and S3 query
SERVE_TENANTS = 128                  # tenants of each S3 stream
SERVE_WAIT_S = 300                   # bound on every wait of the step
SERVE_TURNS = (1, 2, 2, 1, 1, 2, 2, 1)  # depths of the S1 and S2 replays


def drain(loop) -> None:
    """``loop.drain()``, bounded by SERVE_WAIT_S: the wait runs on a
    daemon thread."""
    import threading
    waiter = threading.Thread(target=loop.drain, daemon=True)
    waiter.start()
    waiter.join(SERVE_WAIT_S)
    check(not waiter.is_alive(), f"the serve loop did not drain in "
          f"{SERVE_WAIT_S} s")


def percentiles(tickets) -> tuple[float, float]:
    """p50 and p99 latency (ms) of resolved tickets, as the reference's
    serving_latency reads them."""
    lats = sorted(t.latency for t in tickets)
    return (lats[len(lats) // 2] * 1e3,
            lats[min(len(lats) - 1, int(len(lats) * 0.99))] * 1e3)


def replay(engine, reqs, arrivals, depth, width, kernels):
    """Submit ``reqs`` at their arrival offsets (seconds) through a
    ``ServeLoop(depth=depth, max_wave=width)``; returns the tickets, the
    loop's stats and the launches of the run."""
    from repro_torch.serve.loop import ServeLoop
    with Launches(*kernels) as run:
        with ServeLoop(engine, depth=depth, max_wave=width) as loop:
            t0 = time.monotonic()
            tickets = []
            for r, at in zip(reqs, arrivals):
                while time.monotonic() - t0 < at:
                    time.sleep(0.0002)
                tickets.append(loop.submit(r))
            drain(loop)
    return tickets, dict(loop.stats), run.counts


def schedule_cell(name, engine, reqs, arrivals, width, kernels, tag):
    """One arrival schedule replayed in turns at depth 1 and depth 2
    (SERVE_TURNS): every ticket ok and bit for bit the synchronous
    ``submit_many`` answer of its burst, 2 sweep launches a wave; prints
    p50, p99, waves and stage_overlap_s of each replay, then the median
    p50 and p99 per depth, p99(1) / p99(2) of the medians, and in how
    many turn pairs depth 2 had the lower p99."""
    want = []
    for i in range(0, len(reqs), width):
        want += engine.submit_many(reqs[i:i + width])
    p50s, p99s = {1: [], 2: []}, {1: [], 2: []}
    for depth in SERVE_TURNS:
        tickets, stats, counts = replay(engine, reqs, arrivals, depth,
                                        width, kernels)
        check(all(t.status == "ok" for t in tickets)
              and stats["completed"] == len(reqs),
              f"{name} depth {depth}: not every ticket is ok ({stats})")
        check(all(buffers_equal(t.result[0], w[0])
                  for t, w in zip(tickets, want)),
              f"{name} depth {depth}: a ticket differs from the "
              f"synchronous submit_many")
        check(counts == (2 * stats["waves"], 0),
              f"{name} depth {depth}: launches {counts} for "
              f"{stats['waves']} waves, expected 2 sweeps a wave")
        p50, p99 = percentiles(tickets)
        p50s[depth].append(p50)
        p99s[depth].append(p99)
        print(f"{tag} {name} depth={depth}: p50 {p50:.3f} ms, p99 "
              f"{p99:.3f} ms, waves {stats['waves']}, stage_overlap_s "
              f"{stats['stage_overlap_s']:.6f}, launches {counts}; every "
              f"ticket bitwise the synchronous submit_many")
    med = {d: (sorted(v)[len(v) // 2], sorted(p99s[d])[len(v) // 2])
           for d, v in p50s.items()}
    pairs = list(zip(SERVE_TURNS[::2], SERVE_TURNS[1::2]))
    it = {1: iter(p99s[1]), 2: iter(p99s[2])}
    wins = 0
    for a, b in pairs:
        got = {a: next(it[a]), b: next(it[b])}
        wins += got[2] < got[1]
    print(f"{tag} {name}: over {len(p99s[1])} replays a depth, median p50 "
          f"{med[1][0]:.3f} / {med[2][0]:.3f} ms and median p99 "
          f"{med[1][1]:.3f} / {med[2][1]:.3f} ms at depth 1 / 2; "
          f"p99(depth 1) / p99(depth 2) = {med[1][1] / med[2][1]:.4f}; "
          f"depth 2 had the lower p99 in {wins} of {len(pairs)} turn pairs")


def gil_check() -> None:
    """``torch.cuda.Event.synchronize`` releases the interpreter lock:
    the main thread keeps running Python while a second thread waits on
    an event behind device work (the completion thread's wait)."""
    import threading
    torch.cuda.synchronize()
    ev = torch.cuda.Event()
    torch.cuda._sleep(200_000_000)   # cycles: about 0.1 s of device time
    ev.record()
    waiter = threading.Thread(target=ev.synchronize)
    t0 = time.perf_counter()
    waiter.start()
    spins = 0
    while waiter.is_alive():
        spins += 1
    waited = (time.perf_counter() - t0) * 1e3
    waiter.join()
    check(waited > 10 and spins > 10_000, f"Event.synchronize: the main "
          f"thread ran {spins} loop turns in {waited:.3f} ms of waiting")
    print(f"Event.synchronize releases the interpreter lock: the main "
          f"thread ran {spins} loop turns while another thread waited "
          f"{waited:.3f} ms on an event")


def donation_run(x, cfg, where, kernels):
    """Step 5's ten inserts of ``x`` into a state, then into a 4-epoch
    window advancing after every second, under ``cfg`` (its ``donate``):
    returns every state, window and snapshot (copied to the host, so
    that they hold no device memory), the insert and window-insert ms
    (CUDA events, one call each) and the peak device memory of each
    part above what was allocated when it began.  Donated leaves must
    keep their ``data_ptr``."""
    from repro_torch.core import api
    from repro_torch.core import windowed as win
    kept, t_ins, t_win, peaks = [], [], [], []
    for part in ("state", "window"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        state = (api.init_state(cfg, D_MAIN) if part == "state" else
                 win.init_window_state(cfg, D_MAIN, epochs=4))
        ptrs = [leaf.data_ptr() for leaf in state]
        for i in range(N_MAIN // CHUNK):
            chunk = x[i * CHUNK:(i + 1) * CHUNK]
            with Launches(*kernels) as run:
                if part == "state":
                    (state, _), ms = event_ms(
                        lambda: api.insert_chunk(state, chunk, cfg=cfg))
                    snap = api.finalize(state, cfg=cfg)
                else:
                    (state, _), ms = event_ms(
                        lambda: win.insert_chunk(state, chunk, cfg=cfg))
                    if i % 2:
                        state, _ = win.advance_epoch(state,
                                                     donate=cfg.donate)
                    snap = win.finalize(state, cfg=cfg)
            want = (2, 2) if part == "state" else (3, 2)
            check(run.counts == want, f"{where} {part} insert {i + 1}: "
                  f"launches {run.counts}, expected {want}")
            (t_ins if part == "state" else t_win).append(ms)
            kept += [tuple(leaf.to("cpu", copy=True) for leaf in state),
                     tuple(leaf.to("cpu", copy=True) for leaf in snap)]
        check(not cfg.donate or [leaf.data_ptr() for leaf in state] == ptrs,
              f"{where}: a donated {part} leaf moved")
        del state, snap, chunk
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
    return kept, t_ins, t_win, *peaks


def serve_phase(tag, kernels, dev=torch.device("cuda")) -> None:
    """The serve loop and donation on the card (S1-S5, see the module
    docstring)."""
    from repro_torch.analysis.verifier import no_sync
    from repro_torch.core import datagen, parallel
    from repro_torch.serve import engine as eng
    from repro_torch.serve import loop as loop_mod
    from repro_torch.serve.api import SkylineRequest, StreamOptions
    from repro_torch.serve.loop import ServeLoop, Ticket
    import numpy as np
    t_phase = time.perf_counter()
    dists = ("uniform", "correlated", "anticorrelated")
    if dev.type == "cuda":
        gil_check()

    # -- S1: the reference's serving_latency schedule --------------------------
    engine = eng.SkylineEngine(parallel.SkyConfig(
        strategy="sliced", p=4, capacity=512, block=64, bucket_factor=4.0),
        device=dev)
    rng = np.random.default_rng(0)
    total = SERVE_BURSTS * SERVE_WIDTH
    datas = [np.asarray(rng.random((SERVE_N, D_MAIN)), np.float32)
             for _ in range(total)]
    arrivals = np.repeat(np.cumsum(rng.exponential(
        SERVE_GAP_MS / 1e3, SERVE_BURSTS)), SERVE_WIDTH)
    reqs = [SkylineRequest(data=x) for x in datas]
    for w in range(1, SERVE_WIDTH + 1):
        engine.submit_many(reqs[:w])
    schedule_cell(f"S1 serving_latency ({SERVE_BURSTS} bursts of "
                  f"{SERVE_WIDTH}, n={SERVE_N}, mean gap {SERVE_GAP_MS} ms, "
                  f"host data)", engine, reqs, arrivals, SERVE_WIDTH,
                  kernels, tag)

    # -- S2: the same schedule at full size ------------------------------------
    cfg = parallel.SkyConfig(capacity=65536)
    engine = eng.SkylineEngine(cfg, device=dev)
    big = []
    for i in range(total):
        gen = torch.Generator(device=dev).manual_seed(7000 + i)
        big.append(SkylineRequest(data=datagen.generate(
            dists[i % 3], gen, SERVE_BIG_N, D_MAIN)))
    t_wave, _ = time_ms(lambda: engine.submit_many(big[:SERVE_WIDTH]))
    arrivals = np.repeat(np.cumsum(np.random.default_rng(0).exponential(
        t_wave / 1e3, SERVE_BURSTS)), SERVE_WIDTH)
    schedule_cell(f"S2 ({SERVE_BURSTS} bursts of {SERVE_WIDTH}, "
                  f"N={SERVE_BIG_N}, mean gap {t_wave:.3f} ms = one "
                  f"{SERVE_WIDTH}-query wave, card data)", engine, big,
                  arrivals, SERVE_WIDTH, kernels, tag)
    probe = ServeLoop(engine)
    no_sync(lambda: probe._stage_once(
        [Ticket("query", request=r) for r in big[:SERVE_WIDTH]]))
    torch.cuda.synchronize()
    print("S2: ServeLoop._stage_once of one wave under "
          "set_sync_debug_mode('error'): no host sync raised")

    # -- S3: E5's traffic fed through the loop, with S2's queries -------------
    serial = eng.SkylineEngine(cfg, device=dev)
    g = torch.Generator().manual_seed(2025)
    gen = torch.Generator(device=dev).manual_seed(56)
    waves = []
    for w in range(STREAM_WAVES):
        ns = torch.randint(CHUNK_ROWS[0], CHUNK_ROWS[1] + 1,
                           (2 * SERVE_TENANTS,), generator=g).tolist()
        waves.append([datagen.anticorrelated(gen, n, D_MAIN) for n in ns])
    halves = [(c[:SERVE_TENANTS], c[SERVE_TENANTS:]) for c in waves]
    streams = [engine.open_stream(D_MAIN, StreamOptions(q=SERVE_TENANTS,
                                                        key=k))
               for k in (1, 2)]
    refs = [serial.open_stream(D_MAIN, StreamOptions(q=SERVE_TENANTS,
                                                     key=k))
            for k in (1, 2)]
    probe_engine = eng.SkylineEngine(cfg, device=dev)
    probe_streams = [probe_engine.open_stream(
        D_MAIN, StreamOptions(q=SERVE_TENANTS, key=k)) for k in (1, 2)]
    probe = ServeLoop(probe_engine)
    no_sync(lambda: probe._stage_once(
        [Ticket("feed", stream=s, chunks=list(c), masks=[None] * len(c))
         for s, c in zip(probe_streams, halves[0])]
        + [Ticket("query", request=big[0])]))
    torch.cuda.synchronize()
    print("S3: ServeLoop._stage_once of one fused feed wave and a query "
          "under set_sync_debug_mode('error'): no host sync raised")
    calls = {"feed": [], "query": [], "promotions": 0}

    def counted(kind, fn):
        def wrapper(*args, **kw):
            before = [k.launches for k in kernels]
            out = fn(*args, **kw)
            calls[kind].append(tuple(k.launches - b
                                     for k, b in zip(kernels, before)))
            return out
        return wrapper

    orig_promote = eng.SkylineStream._promote

    def promote(self, *args):
        if self.engine is engine:
            calls["promotions"] += 1
        return orig_promote(self, *args)

    orig_feed, orig_submit = loop_mod._wave_feed, engine.submit_many
    loop_mod._wave_feed = counted("feed", orig_feed)
    engine.submit_many = counted("query", orig_submit)
    eng.SkylineStream._promote = promote
    try:
        with Launches(*kernels) as run:
            with ServeLoop(engine, depth=2) as loop:
                tickets = []
                for w, (ca, cb) in enumerate(halves):
                    tickets.append(loop.feed(streams[0], ca))
                    tickets.append(loop.feed(streams[1], cb))
                    tickets.append(loop.submit(big[w]))
                drain(loop)
                promoted_in_loop = calls["promotions"]
    finally:
        loop_mod._wave_feed = orig_feed
        engine.submit_many = orig_submit
        eng.SkylineStream._promote = orig_promote
    stats = loop.stats
    check(all(t.status == "ok" for t in tickets),
          f"S3: not every ticket is ok ({stats})")
    check(stats["coalesced_feeds"] >= 1, f"S3: no feeds coalesced ({stats})")
    check(promoted_in_loop >= 1, "S3: no promotion rode a pending record "
          "while the loop served")
    check(not loop._watch, f"S3: {len(loop._watch)} streams still watched "
          f"after close")
    check(all(c in ((2, 2), (4, 4)) for c in calls["feed"]),
          f"S3: launches per fused feed wave {calls['feed']}")
    check(all(c == (2, 0) for c in calls["query"]),
          f"S3: launches per query wave {calls['query']}")
    check(run.counts == tuple(map(sum, zip(*(calls["feed"]
                                              + calls["query"])))),
          f"S3: launches {run.counts} do not add up per wave")
    for ca, cb in halves:
        refs[0].feed(ca)
        refs[1].feed(cb)
    for s, r in zip(streams, refs):
        s.drain()
        r.drain()
        check(all(buffers_equal(a, b) for a, b in
                  zip(s.snapshot(), r.snapshot())),
              "S3: after drain() a snapshot differs from serial feeds on a "
              "second engine")
    for t, w in zip(tickets[2::3], range(STREAM_WAVES)):
        (buf, _), = engine.submit_many([big[w]])
        check(buffers_equal(t.result[0], buf),
              f"S3: query {w} differs from the synchronous submit_many")
    p50, p99 = percentiles(tickets)
    print(f"{tag} S3 feeds through the loop: two {SERVE_TENANTS}-tenant "
          f"streams of one bucket, {STREAM_WAVES} waves of "
          f"{CHUNK_ROWS[0]}..{CHUNK_ROWS[1]} anticorrelated rows a tenant, "
          f"with a query of N={SERVE_BIG_N} per wave, depth=2: "
          f"{stats['waves']} loop waves, {len(calls['feed'])} feed waves "
          f"(launches {sorted(set(calls['feed']))} each), coalesced_feeds "
          f"{stats['coalesced_feeds']}, {promoted_in_loop} promotions "
          f"while serving ({calls['promotions']} in all), p50 {p50:.3f} "
          f"ms, p99 {p99:.3f} ms, stage_overlap_s "
          f"{stats['stage_overlap_s']:.6f}; after drain() every snapshot "
          f"bitwise the serial feeds', every query the synchronous "
          f"answer; no stream watched after close")
    for s in streams + refs + probe_streams:
        s.close()

    # -- S4: admission -----------------------------------------------------------
    burst = big[:SERVE_WIDTH]
    with ServeLoop(engine) as loop:
        now = loop._clock()
        doomed = [loop.submit(dataclasses.replace(r, deadline=now - 1))
                  for r in burst]
        kept = [loop.submit(r) for r in burst]
        drain(loop)
    check(all(t.status == "shed" and t.result is None for t in doomed)
          and all(t.status == "ok" for t in kept)
          and loop.stats["shed"] == len(burst)
          and loop.stats["completed"] == len(burst),
          f"S4: past deadlines: {loop.stats}")
    with ServeLoop(engine, degrade=True) as loop:
        now = loop._clock()
        late = [loop.submit(dataclasses.replace(r, deadline=now - 1))
                for r in burst]
        drain(loop)
    check(all(t.status == "ok" and t.degraded
              and t.request.data.device == engine.device for t in late)
          and loop.stats["degraded"] == len(burst)
          and loop.stats["shed"] == 0, f"S4 degrade: {loop.stats}")
    for t, r in zip(late, burst):
        buf, _ = engine.submit(SkylineRequest(data=r.data[::2]))
        check(buffers_equal(t.result[0], buf), "S4: a degraded answer "
              "differs from submit(data[::2])")
    loop = ServeLoop(engine, max_wave=4, max_queue=2, clock=lambda: 100.0)
    loop._started = True  # enqueue without running the threads
    order = [200.0, 150.0, 300.0, None, 250.0]
    ts = [loop.submit(dataclasses.replace(burst[0], deadline=dl))
          for dl in order]
    with loop._lock:
        batch = loop._admit_locked()
    check([t.status for t in ts] == ["shed", "shed", "pending", "pending",
                                     "shed"]
          and batch == [ts[2], ts[3]] and loop.stats["shed"] == 3,
          f"S4 overload: statuses {[t.status for t in ts]}")
    no_sync(lambda: loop._stage_once(batch))
    want, _ = engine.submit(burst[0])
    check(all(buffers_equal(t.result[0], want) for t in batch),
          "S4 overload: an admitted answer differs")
    print(f"{tag} S4 admission: {len(burst)} requests of N={SERVE_BIG_N} "
          f"past their deadline shed and {len(burst)} undated answered; "
          f"under degrade=True all {len(burst)} answered on data[::2] "
          f"(still on the card), bitwise submit(data[::2]); above "
          f"max_queue=2 the deadlines 150, 200, 250 shed oldest first, "
          f"300 and the undated admitted in that order and answered")

    # -- S5: donation on and off, in turns ----------------------------------------
    for seed, dist in ((0, "uniform"), (2, "anticorrelated")):
        gen = torch.Generator(device=dev).manual_seed(1000 + seed)
        x = datagen.generate(dist, gen, N_MAIN, D_MAIN)
        runs = {True: [], False: []}
        for donate in (True, False, False, True):
            runs[donate].append(donation_run(x, dataclasses.replace(
                cfg, donate=donate), f"S5 {dist}", kernels))
        first = runs[True][0][0]
        check(all(leaves_equal(a, b) for r in runs[True][1:] + runs[False]
                  for a, b in zip(r[0], first)),
              f"S5 {dist}: donation on and off give different bits")

        def mode(donate):
            rs = runs[donate]
            return (f"insert {span([t for r in rs for t in r[1]])}, "
                    f"window insert {span([t for r in rs for t in r[2]])}, "
                    f"peak bytes {[r[3] for r in rs]} (inserts) and "
                    f"{[r[4] for r in rs]} (window)")
        print(f"{tag} S5 donation {dist} N={N_MAIN} (ten inserts of {CHUNK} "
              f"rows into a state, then into a 4-epoch window advancing "
              f"after every second; turns on, off, off, on): every state, "
              f"window and snapshot bitwise alike on and off; donated "
              f"leaves kept their data_ptr; CUDA events, one call each, "
              f"both turns of a mode together; peak device memory above "
              f"what was allocated when the part began. On: {mode(True)}. "
              f"Off: {mode(False)}")
    print(f"{tag} serve step ran {time.perf_counter() - t_phase:.3f} s")


def real_data_phase(cfg, tag, kernels):
    """The paper's real datasets at their published shapes, HOU
    (2,049,280 x 7) and RES (3,569,678 x 7), as the surrogate (no CSV is
    in the repository): the default query, grid (m = 2, p = 128) and
    angular (m = 2, p = 64), buckets sized to the largest and local
    windows to the capacity; each bit for bit the plain version's and the
    default answer, launches counted, timed."""
    from repro_torch.core import api, datagen, parallel
    for name in ("hou", "res"):
        n, d = datagen.REAL_SHAPES[name]
        t0 = time.perf_counter()
        x = datagen.load_real(name, n, d)
        torch.cuda.synchronize()
        t_load = (time.perf_counter() - t0) * 1e3
        mask = torch.ones((n,), dtype=torch.bool, device=x.device)
        print(f"{tag} load_real({name!r}) surrogate {n} x {d}: seed "
              f"abs(hash({name!r})) % 2**31 = {abs(hash(name)) % 2 ** 31} in "
              f"this process, made on the host in {t_load:.3f} ms")
        default = None
        for label, fields in (("default", {}),
                              ("grid m=2 p=128", dict(strategy="grid", m=2)),
                              ("angular m=2 p=64", dict(strategy="angular",
                                                        m=2))):
            qcfg = dataclasses.replace(cfg, **fields)
            if fields:
                # one cell holds most rows of this skewed data: the bucket
                # capacity fits it, the local windows stay at the capacity
                _, _, st = parallel.partition_stage(x, mask, qcfg)
                qcfg = dataclasses.replace(
                    qcfg, local_capacity=cfg.capacity,
                    bucket_capacity=_ceil_to(int(st["bucket_counts"].max()),
                                             cfg.block))
            with Launches(*kernels) as run:
                buf, stats = api.parallel_skyline(x, cfg=qcfg)
            ref, rstats = api.parallel_skyline(
                x, cfg=dataclasses.replace(qcfg, impl="torch"))
            check(run.counts == (2, 0) and not bool(buf.overflow)
                  and leaves_equal(buf, ref) and stats_equal(stats, rstats),
                  f"{name} {label}: launches {run.counts}, overflow or a "
                  f"result that differs from impl='torch'")
            if default is None:
                default = buf
            check(leaves_equal(buf, default), f"{name} {label}: the result "
                  f"differs from the default query's")
            e2e, runs = time_ms(lambda: api.parallel_skyline(x, cfg=qcfg))
            print(f"{tag} real {name} {label} N={n} d={d}: {e2e:.3f} ms best "
                  f"of 3 ({', '.join(f'{t:.3f}' for t in runs)}); skyline "
                  f"{int(buf.count)}, largest bucket "
                  f"{int(stats['bucket_counts'].max())} of "
                  f"{stats['bucket_counts'].shape[0]}; launches "
                  f"{run.counts}; bitwise equal to impl='torch' and the "
                  f"default answer")


def verify_phase(tag, kernels) -> None:
    """Step V: the program verifier (``repro_torch.analysis``) on the
    card over every cell of its suite, with the 'auto' registry choice
    (the CUDA kernels): each cell under set_sync_debug_mode("error") and
    a dispatch census, captured into a CUDA graph at q and 2q, under the
    memory and shared-memory caps.  First, which host operations of the
    census raise under set_sync_debug_mode("error") on this card."""
    from repro_torch.analysis.verifier import (HOST_OPS, host_op_probe,
                                               verify_programs)
    t0 = time.perf_counter()
    probe = host_op_probe(torch.device("cuda"))
    listed = {k: v for k, v in probe.items() if "none expected" not in k}
    quiet = sorted(k for k, v in listed.items() if not v)
    loud = sorted(k for k, v in probe.items()
                  if v and "none expected" in k)
    print(f"{tag} V host-op probe: {sum(listed.values())} of "
          f"{len(listed)} census host operations raise under "
          f"set_sync_debug_mode('error') (HOST_OPS holds {len(HOST_OPS)} "
          f"aten names); not raising: {quiet or 'none'}; raising where "
          f"none was expected: {loud or 'none'}")
    with Launches(*kernels) as run:
        report, errors = verify_programs(device="cuda")
    for name, rec in report["cells"].items():
        if "error" in rec:
            print(f"{tag} V {name}: {rec['error']}")
            continue
        graph = rec.get("graph", {})
        mem = rec["memory"]
        nodes = " / ".join(
            f"{k} {graph[k].get('kernel', 0)}" for k in ("q", "2q")
            if k in graph)
        qcount = (f", ops at 2q {rec['op_count_2q']}"
                  if "op_count_2q" in rec else "")
        print(f"{tag} V {name} ({rec['kind']}): {rec['ops']} ops"
              f"{qcount}, kernel calls {rec['kernels']}, graph kernel "
              f"nodes {nodes} (all nodes {graph.get('q')}), peak "
              f"{mem['peak_bytes']} B ({mem['call_bytes']} B beyond the "
              f"inputs), smem sweep {rec['smem']['sweep']} B / dominance "
              f"{rec['smem']['dominance']} B, {rec['seconds']:.3f} s")
    for e in errors:
        print(f"VERIFY {e}")
    check(not errors, f"step V: {len(errors)} invariant violation(s)")
    check(all(run.counts), f"step V: launches {run.counts}: a kernel of "
          f"the suite never launched")
    print(f"{tag} V: {len(report['cells'])} programs verified on the card "
          f"(smem cap {report['smem_cap']} B, memory cap "
          f"{report['mem_cap']} B), launches {run.counts}, "
          f"{time.perf_counter() - t0:.3f} s")


# -- M. the multi-device merge ------------------------------------------------

MESH_CFGS = {"flat": {}, "tree": dict(merge="tree"),
             "tree-noseq": dict(merge="tree", noseq=True),
             "tree-sorted": dict(merge="tree", rep_filter="sorted")}
SHARED_CFGS = {"flat": {}, "flat-noseq": dict(noseq=True),
               "tree": dict(merge="tree"),
               "tree-noseq": dict(merge="tree", noseq=True)}
MESH_CELLS = ("fused_p512", "tree_merge_p512", "batch_8x64", "stream_8x64",
              "window_8x64", "window_tick", "slab_feed", "slab_wave")
SHARED_NOTE = ("one card shared by W ranks: a check of the schedule, not "
               "of scaling")
MESH_DEADLINE_S = 200.0


def _data(dist: str, seed: int, dev):
    from repro_torch.core import datagen
    gen = torch.Generator(device=dev).manual_seed(1000 + seed)
    return datagen.generate(dist, gen, N_MAIN, D_MAIN)


def mesh_rank() -> dict:
    """One rank of a world spawned by step M: the anticorrelated N = 10^7
    query under each of `SHARED_CFGS` on the world's mesh, held bit for
    bit against this rank's one-device answer, with its collectives
    (the verifier's census), launches and time."""
    from repro_torch.analysis.verifier import Census
    from repro_torch.core import parallel
    from repro_torch.kernels.dominance import kernel as dkernel
    from repro_torch.kernels.sfs import kernel
    from repro_torch.launch import mesh as tmesh
    mesh = tmesh.make_worker_mesh()
    x = _data("anticorrelated", 2, mesh.device)
    kernels = (kernel.sfs_sweep_cuda, dkernel.dominated_mask_cuda)
    out = {"backend": mesh.backend, "device": str(mesh.device),
           "staged": sorted(mesh.staged), "cfgs": {}}
    for name, kw in SHARED_CFGS.items():
        cfg = parallel.SkyConfig(capacity=65536, **kw)
        with Launches(*kernels) as run, Census() as census:
            got, _ = parallel.parallel_skyline(x, cfg=cfg, mesh=mesh)
        want, _ = parallel.parallel_skyline(x, cfg=cfg)
        # NoSeq queries get one timed call: under the tree merge its
        # per-row filter takes seconds on a shared card
        ms, runs = time_ms(lambda: parallel.parallel_skyline(
            x, cfg=cfg, mesh=mesh), reps=1 if cfg.noseq else 3)
        out["cfgs"][name] = {
            "equal": leaves_equal(got, want), "count": int(got.count),
            "overflow": bool(got.overflow), "launches": run.counts,
            "rounds": census.collectives[("ppermute", "workers")],
            "collectives": sum(census.collectives.values()),
            "largest": census.collective_elems,
            "bound": 4 * -(-cfg.capacity // cfg.block) * cfg.block
            * (D_MAIN + 2),
            # the flat merge's largest collective is its all_gather of
            # the local skylines' points
            "flat_rows": census.collective_elems // D_MAIN
            if not kw.get("merge") else 0,
            "ms": ms, "runs": runs}
    out["calibration"] = _calibrate(tmesh.make_engine_mesh())
    return out


def _calibrate(mesh) -> dict:
    """`calibrate_shard_threshold` on an engine over ``mesh`` at one
    bucket of 2^16 rows (CUDA events; every rank takes the largest time
    over the mesh): the report's threshold and factorings."""
    from repro_torch.core.parallel import SkyConfig
    from repro_torch.serve.engine import (SkylineEngine,
                                          calibrate_shard_threshold)
    engine = SkylineEngine(SkyConfig(capacity=4096), mesh=mesh)
    rep = calibrate_shard_threshold(engine, bucket_sizes=(2 ** 16,),
                                    repeat=1)
    (nb, t), = rep["measurements"].items()
    return {"threshold_n": rep["threshold_n"], "factorings":
            rep["factorings"], "vmap_s": t["vmap"],
            "per_factoring_s": t["factorings"], "merge_s": t["merge"]}


def _spawn_world(size: int) -> list:
    """`mesh_rank` in every rank of a world of ``size`` spawned on the
    card(s); returns their reports by rank.  A rank that fails or does
    not report within the deadline fails the run, and every rank is
    stopped."""
    from repro_torch.launch.mesh import run_world
    try:
        return run_world(mesh_rank, size, device=None,
                         deadline=MESH_DEADLINE_S, timeout=120.0)
    except RuntimeError as e:
        fail(f"step M: world of {size}: {e}")


def _print_world(tag, size: int, reports, shared: bool) -> None:
    cal = [rep["calibration"] for rep in reports]
    check(all(c["factorings"] == cal[0]["factorings"]
              and c["threshold_n"] == cal[0]["threshold_n"] for c in cal),
          f"step M: W={size} ranks calibrated different choices: {cal}")
    print(f"{tag} M W={size} calibrate_shard_threshold (one 2^16-row "
          f"bucket, seconds, the largest over the ranks): {cal[0]}"
          + (f" [{SHARED_NOTE}]" if shared else ""))
    for rank, rep in enumerate(reports):
        for name, c in rep["cfgs"].items():
            check(c["equal"], f"step M: W={size} rank {rank} {name}: the "
                  f"mesh answer differs from the one-device answer")
            check(c["largest"] <= c["bound"] or not name.startswith("tree"),
                  f"step M: W={size} rank {rank} {name}: a collective of "
                  f"{c['largest']} elements above 4*C*(d+2) = {c['bound']}")
            print(f"{tag} M W={size} rank {rank} ({rep['backend']}, "
                  f"{rep['device']}, staged {rep['staged'] or 'none'}) "
                  f"{name}: bitwise the one-device answer (skyline "
                  f"{c['count']}, overflow {c['overflow']}), tree rounds "
                  f"{c['rounds']}, launches (sweep, dominance) "
                  f"{c['launches']}, {c['collectives']} collectives, largest"
                  f" {c['largest']} elements (4*C*(d+2) = {c['bound']})"
                  + (f", the flat all_gather moves {c['flat_rows']} rows"
                     if c["flat_rows"] else "")
                  + f", query {c['ms']:.3f} ms best of {len(c['runs'])} "
                  f"({', '.join(f'{t:.3f}' for t in c['runs'])})"
                  + (f" [{SHARED_NOTE}]" if shared else ""))


def mesh_phase(tag, kernels, data=None) -> None:
    """Step M: the multi-device merge.  A world of one rank under NCCL on
    the card: the flat merge, the tree merge, NoSeq under the tree merge
    and rep_filter='sorted' on the three distributions at N = 10^7, ten
    streaming inserts of 10^6 rows on the mesh, every answer bit for bit
    the one-device answer, then the verifier's mesh cells on 1 x 1
    meshes (sync debug mode, CUDA graph capture at q and 2q).  Then worlds of 2 and 4 ranks
    sharing the card (gloo, ppermute staged through pinned host memory),
    and on a machine with two or more cards a NCCL world of one rank per
    card."""
    from repro_torch.analysis.verifier import verify_programs
    from repro_torch.core import incremental, parallel
    from repro_torch.launch import mesh as tmesh

    t0 = time.perf_counter()
    mesh = tmesh.make_worker_mesh()
    check(mesh.backend == "nccl" and mesh.workers == 1,
          f"step M: the world of one is {mesh.backend} with "
          f"{mesh.workers} workers, expected nccl with 1")
    dev = mesh.device
    for seed, dist in enumerate(("uniform", "correlated", "anticorrelated")):
        x = data[dist] if data else _data(dist, seed, dev)
        for name, kw in MESH_CFGS.items():
            cfg = parallel.SkyConfig(capacity=65536, **kw)
            with Launches(*kernels) as run:
                got, _ = parallel.parallel_skyline(x, cfg=cfg, mesh=mesh)
            want, _ = parallel.parallel_skyline(x, cfg=cfg)
            check(leaves_equal(got, want), f"step M: W=1 {dist} {name}: "
                  f"the mesh answer differs from the one-device answer")
            check(run.counts[0] >= 1, f"step M: W=1 {dist} {name}: "
                  f"launches {run.counts}")
            print(f"{tag} M W=1 nccl {dist} N={N_MAIN} {name}: bitwise the "
                  f"one-device answer (skyline {int(got.count)}), launches "
                  f"(sweep, dominance) {run.counts}")
    x = data["anticorrelated"] if data else _data("anticorrelated", 2, dev)
    cfg = parallel.SkyConfig(capacity=65536, merge="tree")
    state = incremental.init_state(cfg, D_MAIN)
    ref = incremental.init_state(cfg, D_MAIN)
    with Launches(*kernels) as run:
        for lo in range(0, N_MAIN, CHUNK):
            state, _ = incremental.insert_chunk(state, x[lo:lo + CHUNK],
                                                cfg=cfg, mesh=mesh)
    for lo in range(0, N_MAIN, CHUNK):
        ref, _ = incremental.insert_chunk(ref, x[lo:lo + CHUNK], cfg=cfg)
    one, _ = parallel.parallel_skyline(x, cfg=cfg, mesh=mesh)
    fin = incremental.finalize(state, cfg=cfg)
    check(leaves_equal(fin, incremental.finalize(ref, cfg=cfg))
          and leaves_equal(fin, one), "step M: W=1 ten inserts on the mesh "
          "differ from the one-device inserts or the one-shot answer")
    print(f"{tag} M W=1 nccl ten inserts of {CHUNK} anticorrelated rows on "
          f"the mesh (tree merge): bitwise the one-device inserts and the "
          f"one-shot answer, launches {run.counts}")
    report, errors = verify_programs(MESH_CELLS, device="cuda", meshed=True)
    for name, rec in report["cells"].items():
        graph = rec.get("graph", {})
        print(f"{tag} M verifier {name} on mesh {rec.get('mesh')}: "
              f"collectives {rec.get('collectives')}, tree rounds "
              f"{rec.get('tree_rounds')}, boundary "
              f"{rec.get('tree_boundary')}, graph kernel nodes "
              f"{ {k: v.get('kernel', 0) for k, v in graph.items()} }")
    for e in errors:
        print(f"VERIFY {e}")
    check(not errors, f"step M: {len(errors)} verifier violation(s) on "
          f"the mesh cells")
    print(f"{tag} M W=1 calibrate_shard_threshold (one 2^16-row bucket, "
          f"seconds): {_calibrate(tmesh.make_engine_mesh())}")
    print(f"{tag} M world of one: {time.perf_counter() - t0:.3f} s")

    for size in (2, 4):
        t1 = time.perf_counter()
        reports = _spawn_world(size)
        for rep in reports:
            check(rep["backend"] == "gloo" and rep["staged"] == ["ppermute"],
                  f"step M: ranks sharing the card run {rep['backend']} "
                  f"staging {rep['staged']}, expected gloo staging ppermute")
        _print_world(tag, size, reports, shared=True)
        print(f"{tag} M world of {size} on one card: "
              f"{time.perf_counter() - t1:.3f} s")
    cards = torch.cuda.device_count()
    if cards >= 2:
        size = min(4, cards)
        reports = _spawn_world(size)
        for rep in reports:
            check(rep["backend"] == "nccl", f"step M: {size} cards run "
                  f"{rep['backend']}, expected nccl")
        _print_world(tag, size, reports, shared=False)
    else:
        print(f"{tag} M NCCL world of one rank per card: did not run, the "
              f"machine has {cards} card")
    tmesh.close_world()
    print(f"{tag} M: {time.perf_counter() - t0:.3f} s")


# -- T, L, P. the autotuner, the launch entry points, curation ---------------

TUNE_BLOCKS = (128, 256, 512)      # calibrate_kernels' default blocks
ROOT = Path(__file__).resolve().parent
TUNE_TABLE = str(ROOT / "build" / "kernel_tuning.json")
DRYRUN_RESULTS = ROOT / "build" / "dryrun_torch"
SUBPROCESS_S = 600                 # bound on each subprocess of step L
PARETO_N = 131_072                 # examples of step P


def tuning_phase(tag, kernels, data=None) -> str:
    """Step T: `calibrate_kernels` at the reference's defaults (d = 4,
    f32, n = 16,384, p = 8, capacity from SkyConfig(), blocks 128, 256,
    512, repeat 3) on the card: every sweep candidate and the dominance
    entry bit for bit their references, each block's time, the winner
    against the default block 256.  The table is saved under build/ and
    applied to an engine, then each other block as a table entry: each
    tuned engine answers the anticorrelated N = 10^7 default query bit
    for bit as an untuned engine, and each is timed.  Returns the
    table's path."""
    from repro_torch.core import parallel
    from repro_torch.kernels.tuning import (TuningTable, calibrate_kernels,
                                            tuning_key)
    from repro_torch.serve.engine import SkylineEngine, SkylineRequest

    t0 = time.perf_counter()
    probe = SkylineEngine(parallel.SkyConfig())
    with Launches(*kernels) as run:
        rep = calibrate_kernels(probe, blocks=TUNE_BLOCKS, repeat=3)
    table = rep["table"]
    key = tuning_key("sweep", D_MAIN, torch.float32)
    dkey = tuning_key("dominance", D_MAIN, torch.float32)
    ok = rep["keys"][key]["bitwise_ok"]
    check(rep["impl"] == "cuda" and table.topology["platform"] == "cuda",
          f"step T: calibrated {rep['impl']} on "
          f"{table.topology['platform']}, expected the CUDA kernels")
    check(rep["divergent"] == [] and all(ok.values())
          and all(rep["keys"][dkey]["bitwise_ok"].values()),
          f"step T: divergent candidates {rep['divergent']}: {ok}")
    times = rep["keys"][key]["times_us"]
    check(sorted(times) == sorted(f"b{b}/t0" for b in TUNE_BLOCKS),
          f"step T: sweep candidates {sorted(times)}")
    # per candidate a warm-up, 3 timed runs and one checked run
    want = (5 * len(TUNE_BLOCKS), 5)
    check(run.counts == want, f"step T: launches {run.counts}, expected "
          f"{want}")
    win = table.entries[key]
    print(f"{tag} T calibrate_kernels d={D_MAIN} f32 n=16384 p=8 capacity "
          f"{probe.cfg.capacity}: sweep us per block "
          f"{ {k: times[k] for k in sorted(times)} }, each bitwise equal to "
          f"impl='perpair'; winner block {win.block} ({win.time_us} us) "
          f"against the default block 256 ({times['b256/t0']} us, "
          f"{times['b256/t0'] / win.time_us:.3f}x); dominance 'fixed' "
          f"{table.entries[dkey].time_us} us, bitwise equal to the oracle; "
          f"launches (sweep, dominance) {run.counts}")
    path = table.save(TUNE_TABLE)
    check(TuningTable.load(path).to_json() == table.to_json(),
          "step T: the saved table does not load back")

    cfg = parallel.SkyConfig(capacity=65536)
    x = data["anticorrelated"] if data else _data("anticorrelated", 2,
                                                  torch.device("cuda"))
    req = [SkylineRequest(data=x)]
    # one query a bucket (no padding queries): the default query's work
    plain = SkylineEngine(cfg, min_q_bucket=1)
    (base, _), = plain.submit_many(req)
    t_plain, _ = time_ms(lambda: plain.submit_many(req))
    tuned_ms = {}
    for b in TUNE_BLOCKS:
        # the calibrated table, then each other block as a table entry
        entry = dataclasses.replace(win, block=b)
        table_b = TuningTable.load(path) if b == win.block else TuningTable(
            entries={key: entry})
        tuned = SkylineEngine(cfg, min_q_bucket=1)
        tuned.kernel_tuning = table_b
        check(tuned._cfg_for(None, D_MAIN, "float32").block == b,
              f"step T: the engine does not apply block {b}")
        with Launches(*kernels) as run:
            (got, _), = tuned.submit_many(req)
        check(leaves_equal(got, base), f"step T: the engine tuned to block "
              f"{b} answers otherwise than the untuned engine")
        check(run.counts == (2, 0), f"step T: block {b} query launches "
              f"{run.counts}, expected (2, 0)")
        tuned_ms[b], _ = time_ms(lambda: tuned.submit_many(req))
    print(f"{tag} T engine query anticorrelated N={N_MAIN} capacity 65536 "
          f"(one query a bucket): untuned (block 256) {t_plain:.3f} ms; "
          f"tuned to each block {tuned_ms} ms (the table's winner "
          f"{win.block}), every answer bitwise the untuned one (skyline "
          f"{int(base.count)}), launches (2, 0) each; table saved to "
          f"{path}; step T {time.perf_counter() - t0:.3f} s")
    return path


def _launch(args: list[str]) -> list[str]:
    """Run one launch entry point of the port in a subprocess from the root
    of the checkout; its standard output's lines (failing the run on a
    non-zero exit)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True,
                         timeout=SUBPROCESS_S)
    if out.returncode != 0:
        print(out.stdout[-4000:])
        print(out.stderr[-4000:], file=sys.stderr)
        fail(f"step L: {' '.join(args[:3])} exited {out.returncode}")
    print(f"  ({' '.join(args[:2])}: {time.perf_counter() - t0:.3f} s)")
    return out.stdout.splitlines()


def launch_phase(tag, table: str) -> None:
    """Step L: the serve entry point under the launch environment with the
    tuned table (admission, streaming and windowed fronts, the serve
    loop, a sharded batch on a 1 x 1 mesh, then yi-6b whole: prefill
    and greedy decode of 4 x 16 tokens), then the skyline dry run at
    full cell sizes on a world of one, with each cell's peak bytes."""
    t0 = time.perf_counter()
    # the serve entry point builds yi-6b whole (23.19 GB) in its own
    # process: hand back what this process's allocator keeps cached
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    lines = _launch(["repro_torch.launch.env", "--tuning", table,
                     sys.executable, "-m", "repro_torch.launch.serve",
                     "--queues", "2", "--stream-chunks", "4",
                     "--window-epochs", "2", "--serve-loop", "32",
                     "--slo-ms", "200", "--engine-workers", "1"])
    for line in lines:
        print(f"{tag} L {line}")
    m = re.search(r"tuned geometries: (\d+)", "\n".join(lines))
    check(m is not None and int(m.group(1)) >= 1, "step L: the serve "
          "entry point reports no tuned geometry")
    check(any(ln.startswith("[serve] sharded skyline batch") for ln in lines)
          and any(ln.startswith("[serve] serve-loop") for ln in lines),
          "step L: the serve entry point skipped the serve loop or the sharded "
          "batch")
    check(any(re.match(r"\[serve\] generated \(4, 16\) in ", ln)
              for ln in lines), "step L: the serve entry point did not "
          "decode (4, 16) tokens")
    lines = _launch(["repro_torch.launch.dryrun", "--skyline", "--force",
                     "--device", "cuda", "--results", str(DRYRUN_RESULTS)])
    for line in lines:
        print(f"{tag} L {line}")
    check(bool(lines) and lines[-1].endswith(" err=0"),
          f"step L: the dry run ended {lines[-1:]}")
    for path in sorted(DRYRUN_RESULTS.glob("skyline__*.json")):
        rec = json.loads(path.read_text())
        mem = rec["memory"]["0"]
        print(f"{tag} L dryrun {rec['cell']} on mesh {rec['mesh']}: peak "
              f"{mem['peak_bytes']} B ({mem['call_bytes']} B beyond the "
              f"{mem['argument_bytes']} B of inputs), output "
              f"{mem['output_bytes']} B, collectives "
              f"{rec['collectives']['0']}, kernels {rec['kernels']['0']}, "
              f"build and first run {rec['compile_seconds']:.3f} s")
    print(f"{tag} L: {time.perf_counter() - t0:.3f} s")


def pareto_phase(tag, kernels) -> None:
    """Step P: `pareto_mask` and `pareto_select` on 131,072 examples x 3
    criteria from `example_criteria`, one dominance launch each, bit for
    bit the same calls with impl='torch' on the card, and their times."""
    from repro_torch.data import selection

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(21)
    loss = torch.rand(PARETO_N, generator=g, device="cuda")
    lengths = torch.randint(16, 4096, (PARETO_N,), generator=g,
                            device="cuda")
    recency = torch.randint(0, 1000, (PARETO_N,), generator=g,
                            device="cuda")
    crit = selection.example_criteria(loss, lengths, recency)
    check(crit.shape == (PARETO_N, 3) and bool(torch.isfinite(crit).all()),
          "step P: criteria of the wrong shape or not finite")
    with Launches(*kernels) as run:
        front = selection.pareto_mask(crit)
    check(run.counts == (0, 1), f"step P: pareto_mask launches "
          f"{run.counts}, expected (0, 1)")
    with Launches(*kernels) as run_s:
        order, front_s = selection.pareto_select(crit, 1024)
    check(run_s.counts == (0, 1), f"step P: pareto_select launches "
          f"{run_s.counts}, expected (0, 1)")
    plain = selection.pareto_mask(crit, impl="torch")
    p_order, p_front = selection.pareto_select(crit, 1024, impl="torch")
    check(bits_equal(front, plain) and bits_equal(front_s, p_front)
          and bits_equal(order, p_order) and bits_equal(front, front_s),
          "step P: the card's answer differs from impl='torch'")
    t_mask, _ = time_ms(lambda: selection.pareto_mask(crit))
    t_sel, _ = time_ms(lambda: selection.pareto_select(crit, 1024))
    t_plain, _ = time_ms(lambda: selection.pareto_mask(crit, impl="torch"))
    print(f"{tag} P pareto_mask {PARETO_N} x 3: front {int(front.sum())}, "
          f"{t_mask:.3f} ms (impl='torch' {t_plain:.3f} ms), pareto_select "
          f"k=1024 {t_sel:.3f} ms, bitwise equal to impl='torch', launches "
          f"{run.counts} and {run_s.counts}; step P "
          f"{time.perf_counter() - t0:.3f} s")


LM_B, LM_S = 2, 20                 # G1's batch and prompt
LM_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 4e-2)}
CONSISTENCY_TOL = (3e-2, 4e-2)     # tests/test_models_smoke.py:82-91
GEN_B, GEN_PROMPT, GEN_NEW = 4, 32, 16   # G3's generate


def _lm_inputs(cfg, b, s, seed, dev):
    """Inputs of ``s`` text positions (after a VLM's image prefix), the
    next token, and its position, made on the host from ``seed``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    host = ({"frames": rng.standard_normal((b, s, cfg.frontend_dim))}
            if cfg.family == "encoder" else {"tokens": toks[:, :s]})
    if cfg.family == "vlm":
        host["image_emb"] = rng.standard_normal(
            (b, cfg.prefix_len, cfg.frontend_dim))
    inputs = {k: torch.as_tensor(v.astype(np.int32 if k == "tokens"
                                          else np.float32), device=dev)
              for k, v in host.items()}
    pos = s + (cfg.prefix_len if cfg.family == "vlm" else 0)
    return inputs, torch.as_tensor(toks[:, s:s + 1], device=dev), pos


def _lm_run(params, cfg, inputs, tok, pos, cache_len):
    """forward, prefill and one decode step: {name: logits}."""
    from repro_torch.models import transformer as T
    logits, _, _ = T.forward(params, cfg, inputs)
    out = {"forward": logits}
    if cfg.family != "encoder":
        caches, last = T.prefill(params, cfg, inputs, cache_len)
        _, dec = T.decode_step(params, cfg, caches, tok,
                               torch.tensor(pos, dtype=torch.int32,
                                            device=tok.device))
        out.update(prefill=last, decode=dec)
    return {k: v.float().cpu() for k, v in out.items()}


class _Routing:
    """Records the top-k choices of the port's MoE layers, or replays
    recorded ones in their place (``repro_torch.models.moe.topk_order``):
    in bf16 a token whose top two router probabilities lie within
    rounding picks its expert by noise, on the card as on the CPU."""

    def __init__(self, replay=None):
        self.recorded, self.replay = [], replay

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe.topk_order
        queue = list(self.replay or [])

        def order(merit):
            if self.replay is not None:
                return queue.pop(0).to(merit.device)
            idx = self.orig(merit)
            self.recorded.append(idx.cpu())
            return idx

        moe.topk_order = order
        self.queue = queue
        return self

    def __exit__(self, *exc):
        self.moe.topk_order = self.orig


def _close(got, want, tol) -> tuple[bool, float]:
    err = (got - want).abs()
    return bool((err <= tol + tol * want.abs()).all()), float(err.max())


def _norm_ratio(got, want, want32) -> float:
    """|card - CPU| / |CPU bf16 - CPU f32| over all the outputs given:
    at most 1 when the card's bf16 is as close to the CPU's as bf16 is
    to f32."""
    cat = lambda xs: torch.cat([x.reshape(-1) for x in xs])
    own = float((cat(want) - cat(want32)).norm())
    return float((cat(got) - cat(want)).norm()) / own


def _consistency(params, cfg, dev, seed, checked=True
                 ) -> tuple[float, float]:
    """The reference's prefill/decode consistency check
    (tests/test_models_smoke.py): prefill of s tokens and one decode step
    against the full forward over s + 1; the largest errors (checked
    against the reference's tolerances unless ``checked`` is False)."""
    from repro_torch.models import transformer as T
    b, s = 2, 24
    g = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (b, s + 1), generator=g, device=dev,
                         dtype=torch.int32)
    full, _, _ = T.forward(params, cfg, {"tokens": toks})
    caches, last = T.prefill(params, cfg, {"tokens": toks[:, :s]}, 64)
    _, dec = T.decode_step(params, cfg, caches, toks[:, s:s + 1],
                           torch.tensor(s, dtype=torch.int32, device=dev))
    ok1, e1 = _close(last.float().cpu(), full[:, -2].float().cpu(),
                     CONSISTENCY_TOL[0])
    ok2, e2 = _close(dec.float().cpu(), full[:, -1].float().cpu(),
                     CONSISTENCY_TOL[1])
    check(ok1 and ok2 or not checked, f"step G: {cfg.name} prefill/decode "
          f"against the full forward: errors {e1}, {e2} above "
          f"{CONSISTENCY_TOL}")
    return e1, e2


def _condition_attention(params) -> None:
    """Rescale every q and k projection in place to the fan-in of its
    contraction, d_model.  The reference's "scaled" init takes the fan-in
    from the second-to-last axis, the heads, so at yi-6b's width
    (d = 4,096, 32 heads) q and k come out with a standard deviation near
    11 and the attention logits near 128: each softmax is nearly an
    argmax over keys, a rounding difference can flip it, and the
    difference doubles and more from layer to layer (a perturbation of
    1e-7 reached 0.371 after 8 layers, in the port on the CPU:
    ``tests/_lm_bf16_probe.py depth 8``).  Rescaled,
    the logits are O(1) and f32 rounding stays f32 rounding."""
    stack = [params]
    while stack:
        node = stack.pop()
        if not isinstance(node, dict):
            continue
        for name in ("wq", "wk"):
            w = node.get(name)
            if isinstance(w, torch.Tensor):
                w.mul_((w.shape[-2] / w.shape[-3]) ** 0.5)
        stack.extend(v for v in node.values() if isinstance(v, dict))


def _param_bytes(params) -> int:
    total = 0
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            total += node.numel() * node.element_size()
    return total


def lm_phase(tag, dev=torch.device("cuda"), full_config=None) -> None:
    """Step G: the language models (`repro_torch.models`) on the card.
    G1, the ten smoke configs on the card against the port on the CPU
    from the same numpy parameters (forward, prefill, one decode step):
    f32 compute elementwise at 1e-4, bf16 with the CPU's routing replayed
    and norm-wise within bf16's own error (|card - CPU| at most |CPU bf16
    - CPU f32|). G2, yi-6b at full width with 2 layers, card against CPU
    in f32 at 1e-3.  G3, yi-6b whole (32 layers): ``generate`` in bf16 at
    batch 4, prompt 32, 16 new tokens, timed by CUDA events beside the
    parameters' bytes over the memory rate, one decode step traced by
    torch.profiler (device busy and idle share), then the reference's
    prefill/decode consistency check in f32 with q and k rescaled to the
    fan-in of their contraction (`_condition_attention`; the error with
    the init unchanged is printed, not checked).  G4, mixtral-8x7b at full
    width with 2 layers: the consistency check at drop-free capacity.
    ``full_config`` (for a rehearsal on the CPU) maps an arch to the
    config that stands for its full size."""
    from repro_torch import convert
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params

    full_config = full_config or get_config
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "step G: TF32 matmuls are on; f32 compute must be f32")

    # -- G1: the ten smoke configs, card against CPU ------------------------
    for arch in ARCH_NAMES:
        base = dataclasses.replace(get_config(arch, smoke=True), remat=False)
        host = convert.params_to_numpy(
            init_params(T.lm_plan(base), seed=0, device=cpu))
        p_cpu = convert.params_from_numpy(host, device=cpu)
        p_dev = convert.params_from_numpy(host, device=dev)
        line = []
        f32_err = 0.0
        for cd in ("float32", "bfloat16"):
            cfg = dataclasses.replace(base, compute_dtype=cd)
            args = [_lm_inputs(cfg, LM_B, LM_S, 7, d) for d in (cpu, dev)]
            with _Routing() as route:
                want = _lm_run(p_cpu, cfg, *args[0], 32)
            if cd == "float32":
                got = _lm_run(p_dev, cfg, *args[1], 32)
                for name in want:
                    ok, err = _close(got[name], want[name], LM_TOL[cd][0])
                    check(ok, f"step G1: {arch} f32 {name}: card against "
                          f"CPU max error {err} above {LM_TOL[cd][0]}")
                    f32_err = max(f32_err, err)
                line.append(f"f32 card against CPU max error {f32_err:.3g} "
                            f"(at most 1e-4)")
                continue
            f32 = dataclasses.replace(cfg, compute_dtype="float32")
            with _Routing(replay=route.recorded):
                want32 = _lm_run(p_cpu, f32, *args[0], 32)
            with _Routing(replay=route.recorded) as replayed:
                got = _lm_run(p_dev, cfg, *args[1], 32)
            check(not replayed.queue, f"step G1: {arch}: routing left over")
            names = list(want)
            ratio = _norm_ratio([got[n] for n in names],
                                [want[n] for n in names],
                                [want32[n] for n in names])
            check(ratio <= 1.0, f"step G1: {arch} bf16: |card - CPU| is "
                  f"{ratio:.3f} x |CPU bf16 - CPU f32|, above 1")
            errs = {n: float((got[n] - want[n]).abs().max()) for n in names}
            within = all(_close(got[n], want[n],
                                LM_TOL[cd][n == "decode"])[0]
                         for n in names)
            line.append(f"bf16 |card - CPU| / |bf16 - f32| {ratio:.3f}, max "
                        f"errors {errs} ({'within' if within else 'not all within'} "
                        f"3e-2 / 4e-2)")
        print(f"{tag} G1 {arch} smoke: {'; '.join(line)}", flush=True)
        del p_cpu, p_dev, host

    # -- G2: yi-6b at full width, two layers, card against CPU -----------
    cfg2 = dataclasses.replace(full_config("yi-6b"), n_layers=2,
                               compute_dtype="float32", remat=False)
    t2 = time.perf_counter()
    host = convert.params_to_numpy(init_params(T.lm_plan(cfg2), seed=0,
                                               device=cpu))
    p_cpu = convert.params_from_numpy(host, device=cpu)
    p_dev = convert.params_from_numpy(host, device=dev)
    args = [_lm_inputs(cfg2, LM_B, 16, 8, d) for d in (cpu, dev)]
    want = _lm_run(p_cpu, cfg2, *args[0], 32)
    got = _lm_run(p_dev, cfg2, *args[1], 32)
    errs = {}
    for name in want:
        ok, errs[name] = _close(got[name], want[name], 1e-3)
        check(ok, f"step G2: {name}: card against CPU max error "
              f"{errs[name]} above 1e-3")
    print(f"{tag} G2 {cfg2.name} width d={cfg2.d_model}, d_ff={cfg2.d_ff}, "
          f"vocab {cfg2.vocab_padded}, 2 layers, {_param_bytes(p_dev)} B of "
          f"f32 parameters: card against CPU (f32, no TF32) max errors "
          f"{errs} (rtol = atol = 1e-3); {time.perf_counter() - t2:.3f} s",
          flush=True)
    del p_cpu, p_dev, host

    # -- G3: yi-6b whole ----------------------------------------------------
    t3 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg3 = dataclasses.replace(full_config("yi-6b"), remat=False)
    params = init_params(T.lm_plan(cfg3), seed=0, device=dev)
    nbytes = _param_bytes(params)
    f32_3 = dataclasses.replace(cfg3, compute_dtype="float32")
    raw = _consistency(params, f32_3, dev, 9, checked=False)
    assert cfg3.compute_dtype == "bfloat16"
    rng = np.random.default_rng(10)
    prompts = torch.as_tensor(rng.integers(0, cfg3.vocab, (
        GEN_B, GEN_PROMPT)).astype(np.int32), device=dev)
    cache_len = GEN_PROMPT + GEN_NEW
    generate(params, cfg3, prompts, GEN_NEW, cache_len)    # warm-up
    toks, gen_ms = event_ms(lambda: generate(params, cfg3, prompts,
                                             GEN_NEW, cache_len))
    # the same loop, each call timed
    (caches, logits), pre_ms = event_ms(lambda: T.prefill(
        params, cfg3, {"tokens": prompts}, cache_len))
    steps, own = [], []
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for i in range(GEN_NEW):
        own.append(tok)
        pos = torch.tensor(GEN_PROMPT + i, dtype=torch.int32, device=dev)
        (caches, logits), ms = event_ms(lambda: T.decode_step(
            params, cfg3, caches, tok, pos))
        steps.append(ms)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    own = torch.cat(own, dim=1)
    check(tuple(toks.shape) == (GEN_B, GEN_NEW) and toks.dtype == torch.int32
          and bool(((toks >= 0) & (toks < cfg3.vocab_padded)).all()),
          f"step G3: generate gave {tuple(toks.shape)} {toks.dtype}")
    check(torch.equal(toks, own), "step G3: generate's tokens differ from "
          "its own loop's on the same card")
    decode_ms = sum(steps) / len(steps)
    bound_ms = nbytes / MEM_BYTES_PER_S * 1e3
    print(f"{tag} G3 generate {cfg3.name} bf16 compute, batch {GEN_B}, "
          f"prompt {GEN_PROMPT}, {GEN_NEW} new tokens: {gen_ms:.3f} ms "
          f"({GEN_B * GEN_NEW / gen_ms * 1e3:.1f} tok/s); prefill "
          f"{pre_ms:.3f} ms, decode {decode_ms:.3f} ms a step (min "
          f"{min(steps):.3f}, max {max(steps):.3f}); decode bound {nbytes} "
          f"B of parameters read once a step at {MEM_BYTES_PER_S / 1e12} "
          f"TB/s = {bound_ms:.3f} ms ({decode_ms / bound_ms:.2f}x); peak "
          f"device memory {torch.cuda.max_memory_allocated()} B", flush=True)
    trace_call(lambda c: T.decode_step(params, cfg3, c, tok, pos), tag,
               f"one {cfg3.name} bf16 decode step (batch {GEN_B})",
               fresh=lambda: caches)
    del caches, logits
    _condition_attention(params)
    e1, e2 = _consistency(params, f32_3, dev, 9)
    print(f"{tag} G3 {cfg3.name} whole ({cfg3.n_layers} layers, "
          f"{cfg3.param_count()} parameters, {nbytes} B f32): prefill/decode "
          f"consistency in f32 compute with q and k at fan-in d_model, max "
          f"errors {e1:.3g} and {e2:.3g} (at most {CONSISTENCY_TOL}); with "
          f"the reference's init unchanged {raw[0]:.3g} and {raw[1]:.3g} "
          f"(not checked: near-argmax attention amplifies rounding from "
          f"layer to layer); {time.perf_counter() - t3:.3f} s", flush=True)
    del params
    torch.cuda.empty_cache()

    # -- G4: mixtral-8x7b at full width, two layers ----------------------
    t4 = time.perf_counter()
    base4 = full_config("mixtral-8x7b")
    cfg4 = dataclasses.replace(base4, n_layers=2, compute_dtype="float32",
                               remat=False,
                               capacity_factor=float(base4.n_experts))
    params = init_params(T.lm_plan(cfg4), seed=0, device=dev)
    e1, e2 = _consistency(params, cfg4, dev, 11)
    print(f"{tag} G4 {cfg4.name} width d={cfg4.d_model}, {cfg4.n_experts} "
          f"experts of d_ff={cfg4.d_ff}, top-{cfg4.top_k}, 2 layers, "
          f"{_param_bytes(params)} B f32, drop-free capacity: prefill/decode "
          f"consistency max errors {e1:.3g} and {e2:.3g} (at most "
          f"{CONSISTENCY_TOL}); {time.perf_counter() - t4:.3f} s", flush=True)
    del params
    torch.cuda.empty_cache()
    print(f"{tag} G: {time.perf_counter() - t0:.3f} s", flush=True)


# -- step R: training ------------------------------------------------------

R_B, R_S = 4, 32                   # R1's batch (tests/test_models_smoke.py)
R_F32_TOL = 2e-3                   # f32 gradients, norm-wise per leaf
R_UPDATE_TOL = 1e-6                # f32 update differences counted
R2_TOL = 1e-2                      # R2's gradients, norm-wise per leaf
R3_LAYERS, R3_BATCH, R3_SEQ, R3_STEPS = 8, 8, 4096, 4
R3_CKPT_AT = 2
BF16_FLOPS_PER_S = 989.4e12        # H100 SXM dense bf16 (data sheet)
R5_SHAPE = (8, 6, 2, 16)           # L, M, B, D: tests/test_pipeline.py
TRAIN_DEADLINE_S = 200.0


def _flat(tree) -> list:
    """``[(path, leaf)]`` of a nest of dicts, keys sorted."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}" if p else k, x) for k in sorted(tree)
                for p, x in _flat(tree[k])]
    return [("", tree)]


def _cpu_leaves(tree) -> list:
    """A parameter or gradient tree's leaves on the host in f32 (a
    missing gradient as zeros of its parameter's shape elsewhere)."""
    return [(p, None if x is None else x.detach().float().cpu())
            for p, x in _flat(tree)]


def _dist(a, b) -> float:
    return float((a - b).norm())


def _train_run(base, cd, host, dev, opt, routing=None):
    """One config's gradients (``loss_and_grads``) and one
    ``make_train_step`` on ``dev`` from the host parameters ``host``, in
    compute dtype ``cd``; MoE routing recorded, or replayed from
    ``routing``.  Returns (loss, grads, params after the step, metrics,
    the routing recorded)."""
    from repro_torch import convert
    from repro_torch.data.pipeline import DataState, make_batch
    from repro_torch.train import step as S
    cfg = dataclasses.replace(base, compute_dtype=cd)
    batch = make_batch(cfg, R_B, R_S, DataState(0, 0), device=dev)
    with _Routing(replay=routing) as route:
        params = convert.params_from_numpy(host, device=dev)
        loss, _, grads = S.loss_and_grads(params, cfg, batch)
        state, metrics = S.make_train_step(cfg, opt)(
            S.init_state(params, opt), batch)
    if routing is not None:
        check(not route.queue, f"step R1: {base.name}: routing left over")
    grads = [(p, torch.zeros(x.shape) if g is None else g) for (p, g), (_, x)
             in zip(_cpu_leaves(grads), _cpu_leaves(params))]
    return (float(loss), grads, _cpu_leaves(state["params"]),
            {k: float(v) for k, v in metrics.items()}, route.recorded)


def _f32_updates(arch, got, want) -> tuple[float, float, int]:
    """The f32 parameters after one step, card (``got``) against CPU
    (``want``), norm-wise per leaf within ``R_F32_TOL``; returns the
    worst leaf's ratio, the largest elementwise difference and the count
    of elements beyond ``R_UPDATE_TOL``.  Adam's first update is
    ``lr·g/(|g| + eps)``: where a gradient lies within the card's
    rounding of zero it can take another size or sign there (up to
    2 lr), so the elements are counted, not held."""
    worst = biggest = 0.0
    off = 0
    for i, (path, a) in enumerate(got[2]):
        b = want[2][i][1]
        err = _dist(a, b) / max(float(b.norm()), 1e-30)
        check(err <= R_F32_TOL, f"step R1: {arch} f32 parameters {path} "
              f"after the step: card against CPU {err:.3g} of the leaf "
              f"norm, above {R_F32_TOL}")
        worst = max(worst, err)
        biggest = max(biggest, float((a - b).abs().max()))
        off += int(((a - b).abs() > R_UPDATE_TOL).sum())
    return worst, biggest, off


def _train_r1(tag, dev, cpu) -> None:
    """R1: the ten smoke configs, card against CPU."""
    from repro_torch.train.optim import OptConfig
    opt = OptConfig(total_steps=10, warmup_steps=1)
    t0 = time.perf_counter()
    # the smoke models' CPU operations are tiny: one thread is quicker
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _train_r1_configs(tag, dev, cpu, opt)
    finally:
        torch.set_num_threads(threads)
    print(f"{tag} R1: {time.perf_counter() - t0:.3f} s", flush=True)


def _train_r1_configs(tag, dev, cpu, opt) -> None:
    from repro_torch import convert
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params
    for arch in ARCH_NAMES:
        base = dataclasses.replace(get_config(arch, smoke=True),
                                   microbatches=2)
        init = init_params(T.lm_plan(base), seed=0, device=cpu)
        host = convert.params_to_numpy(init)
        p0 = _cpu_leaves(init)
        cpu32 = _train_run(base, "float32", host, cpu, opt)
        dev32 = _train_run(base, "float32", host, dev, opt,
                           cpu32[4] if base.n_experts else None)
        check(abs(dev32[0] - cpu32[0]) <= 1e-5 * abs(cpu32[0]),
              f"step R1: {arch} f32 loss {dev32[0]} on the card, "
              f"{cpu32[0]} on the CPU")
        g_err = 0.0
        for (path, g), (_, w) in zip(dev32[1], cpu32[1]):
            err = _dist(g, w) / max(float(w.norm()), 1e-30)
            check(err <= R_F32_TOL or float(w.norm()) == 0 == float(
                g.norm()), f"step R1: {arch} f32 gradient {path}: "
                f"card against CPU {err:.3g} of its norm, above "
                f"{R_F32_TOL}")
            g_err = max(g_err, err)
        p_ratio, p_err, flips = _f32_updates(arch, dev32, cpu32)
        # bf16: the CPU's routing, replayed on the card and in f32
        cpu16 = _train_run(base, "bfloat16", host, cpu, opt)
        routing = cpu16[4] if base.n_experts else None
        dev16 = _train_run(base, "bfloat16", host, dev, opt, routing)
        ref32 = (_train_run(base, "float32", host, cpu, opt, routing)
                 if routing else cpu32)
        worst_g = worst_p = 0.0
        for i, (path, g) in enumerate(dev16[1]):
            w, w32 = cpu16[1][i][1], ref32[1][i][1]
            bound = max(_dist(w, w32), 1e-3 * float(w32.norm()))
            ratio = _dist(g, w) / bound if bound else _dist(g, w)
            check(ratio <= 1.0, f"step R1: {arch} bf16 gradient {path}: "
                  f"|card - CPU| {_dist(g, w):.4g} above max(|CPU bf16 - "
                  f"CPU f32|, 1e-3 |f32|) = {bound:.4g}")
            worst_g = max(worst_g, ratio)
            # the step's update of this leaf, held the same way
            p_init = p0[i][1]
            d_dev, d_cpu, d_32 = (x[2][i][1] - p_init
                                  for x in (dev16, cpu16, ref32))
            bound = max(_dist(d_cpu, d_32), 1e-3 * float(d_32.norm()))
            ratio = _dist(d_dev, d_cpu) / bound if bound else 0.0
            check(ratio <= 1.0, f"step R1: {arch} bf16 update of {path}: "
                  f"|card - CPU| {_dist(d_dev, d_cpu):.4g} above {bound:.4g}")
            worst_p = max(worst_p, ratio)
        check(abs(dev16[0] - cpu16[0]) <= 3e-2 * abs(cpu16[0]),
              f"step R1: {arch} bf16 loss {dev16[0]} on the card, "
              f"{cpu16[0]} on the CPU")
        print(f"{tag} R1 {arch} smoke, microbatches 2, batch {R_B}x{R_S}: "
              f"f32 loss card {dev32[0]:.7g} / CPU {cpu32[0]:.7g}, "
              f"gradients worst {g_err:.3g} of the leaf norm (at most "
              f"{R_F32_TOL}), parameters after the step worst "
              f"{p_ratio:.3g} of the leaf norm (at most {R_F32_TOL}), max "
              f"|card - CPU| {p_err:.3g}, {flips} element(s) whose update "
              f"differs by more than {R_UPDATE_TOL}; bf16 loss card "
              f"{dev16[0]:.6g} / CPU {cpu16[0]:.6g}, worst leaf |card - "
              f"CPU| / max(|CPU bf16 - f32|, 1e-3 |f32|): gradients "
              f"{worst_g:.3f}, updates {worst_p:.3f} (at most 1)"
              + (", routing replayed" if routing else ""), flush=True)


def _train_r2(tag, dev, cpu, full_config) -> None:
    """R2: yi-6b at its published widths with 2 layers, f32: one
    gradient, card against CPU, norm-wise per leaf within ``R2_TOL``.
    At this width the reference's init makes attention nearly an argmax
    (`_condition_attention`), which amplifies f32 rounding (on an H100:
    4.23e-3 at ``blocks/attn/wq``; 1.79e-6 with q and k rescaled to the
    fan-in d_model)."""
    from repro_torch import convert
    from repro_torch.data.pipeline import DataState, make_batch
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params
    from repro_torch.train import step as S
    t0 = time.perf_counter()
    cfg = dataclasses.replace(full_config("yi-6b"), n_layers=2,
                              compute_dtype="float32", remat=False,
                              microbatches=1)
    host = convert.params_to_numpy(init_params(T.lm_plan(cfg), seed=0,
                                               device=cpu))
    out = []
    for d in (cpu, dev):
        params = convert.params_from_numpy(host, device=d)
        batch = make_batch(cfg, 2, 16, DataState(0, 0), device=d)
        loss, _, grads = S.loss_and_grads(params, cfg, batch)
        out.append((float(loss), _cpu_leaves(grads)))
        del params, grads
    (lc, gc_), (ld, gd) = out
    worst, at = 0.0, ""
    for (path, g), (_, w) in zip(gd, gc_):
        err = _dist(g, w) / max(float(w.norm()), 1e-30)
        if err > worst:
            worst, at = err, path
    check(worst <= R2_TOL and abs(ld - lc) <= 1e-5 * abs(lc),
          f"step R2: gradients card against CPU {worst} of the leaf norm at "
          f"{at} (at most {R2_TOL}), loss {ld} against {lc}")
    print(f"{tag} R2 {cfg.name} width d={cfg.d_model}, {cfg.n_heads} heads "
          f"over {cfg.n_kv_heads} KV heads, d_ff={cfg.d_ff}, vocab "
          f"{cfg.vocab_padded}, 2 layers, f32 (no TF32), batch 2x16: loss "
          f"card {ld:.7g} / CPU {lc:.7g}; gradients card against CPU, "
          f"norm-wise per leaf, worst {worst:.3g} at {at} (tolerance "
          f"{R2_TOL}: near-argmax attention at this width); "
          f"{time.perf_counter() - t0:.3f} s", flush=True)


class _StepTimes:
    """Wraps ``repro_torch.launch.train.make_train_step`` so that every
    step of a ``train_loop`` is timed by CUDA events, and step
    ``trace_step`` (1-based) runs under torch.profiler."""

    def __init__(self, trace_step: int | None = None):
        self.trace_step, self.prof = trace_step, None

    def __enter__(self):
        from repro_torch.launch import train as L
        self.mod, self.orig, self.events = L, L.make_train_step, []

        def make(cfg, opt_cfg, **kw):
            step = self.orig(cfg, opt_cfg, **kw)

            def timed(state, batch):
                from torch.profiler import ProfilerActivity, profile
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                if len(self.events) + 1 != self.trace_step:
                    start.record()
                    out = step(state, batch)
                    end.record()
                else:
                    # the device's activity only: a step is about 19,000
                    # kernels, and the host's events besides would take
                    # the profiler many seconds to gather
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CUDA]) as p:
                        start.record()
                        out = step(state, batch)
                        end.record()
                        torch.cuda.synchronize()
                    self.prof = p
                self.events.append((start, end))
                return out

            return timed

        L.make_train_step = make
        return self

    def __exit__(self, *exc):
        self.mod.make_train_step = self.orig

    def ms(self) -> list:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


class _CkptTimes:
    """Times `CheckpointManager`'s host copy (``save`` until it hands the
    write to its thread), the write it waits for, and ``restore``."""

    def __enter__(self):
        from repro_torch.checkpoint import manager as M
        self.cls, self.t = M.CheckpointManager, {}
        self.orig = {k: getattr(self.cls, k)
                     for k in ("save", "wait", "restore")}

        def timed(name):
            def call(mgr, *a, **k):
                t0 = time.perf_counter()
                try:
                    return self.orig[name](mgr, *a, **k)
                finally:
                    self.t[name] = self.t.get(name, 0.0) + (
                        time.perf_counter() - t0)
            return call

        for k in self.orig:
            setattr(self.cls, k, timed(k))
        return self

    def __exit__(self, *exc):
        for k, f in self.orig.items():
            setattr(self.cls, k, f)

    def report(self) -> str:
        return ", ".join(f"{k} {v:.3f}" for k, v in sorted(self.t.items()))


def _moved(cfg, final, dev) -> list:
    """Leaves (embed, the first attention block's wq) whose values after
    training differ from their initial draw (made again from the same
    per-leaf seeds)."""
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params
    plan = T.lm_plan(cfg)
    sub = {"embed": plan["embed"],
           "blocks": {"attn": {"wq": plan["blocks"]["attn"]["wq"]}}}
    init = init_params(sub, seed=0, device=dev)
    return [p for (p, a), (_, b) in zip(_flat(init), _flat(
        {"embed": final["embed"],
         "blocks": {"attn": {"wq": final["blocks"]["attn"]["wq"]}}}))
        if not torch.equal(a, b)]


def _train_r3(tag, dev, full_config, kernels):
    """R3: ``train_loop`` at yi-6b's published widths, cut to
    ``R3_LAYERS`` layers, bf16 compute, the config's remat and
    microbatches; then a checkpoint, a restart and the same state.
    Returns the thread that deletes the checkpoints."""
    import gc
    import shutil
    import tempfile
    import threading
    from repro_torch.train.optim import OptConfig
    t0 = time.perf_counter()
    cfg = dataclasses.replace(full_config("yi-6b"), n_layers=R3_LAYERS)
    check(cfg.remat and cfg.compute_dtype == "bfloat16",
          f"step R3: {cfg.name} does not remat in bf16 compute")
    opt = OptConfig(total_steps=R3_STEPS,
                    warmup_steps=max(R3_STEPS // 20, 1))
    kw = dict(steps=R3_STEPS, batch=R3_BATCH, seq=R3_SEQ, opt_cfg=opt,
              log_every=1, device=dev)
    from repro_torch.models import transformer as T
    from repro_torch.models.common import plan_leaves
    n = cfg.param_count()              # the products' parameters
    held = sum(int(np.prod(spec.shape))
               for _, spec in plan_leaves(T.lm_plan(cfg)))
    tokens = R3_BATCH * R3_SEQ
    attn = 12 * R3_SEQ ** 2 * cfg.n_heads * cfg.head_dim_eff \
        * cfg.n_layers * R3_BATCH
    flops = 6 * n * tokens + attn
    bound_ms = flops / BF16_FLOPS_PER_S * 1e3
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ckpt = tempfile.mkdtemp(prefix="r3_ckpt_")
    marks = [("set-up", time.perf_counter())]
    try:
        _train_r3_runs(tag, dev, cfg, kw, kernels, ckpt,
                       (n, held, tokens, attn, flops, bound_ms), marks)
    except BaseException:
        shutil.rmtree(ckpt, ignore_errors=True)
        raise
    # the checkpoints' 40 GB take seconds to delete: beside R5
    removal = threading.Thread(target=shutil.rmtree, args=(ckpt,),
                               kwargs={"ignore_errors": True})
    removal.start()
    phases = [(marks[i][0], marks[i][1] - (marks[i - 1][1] if i else t0))
              for i in range(len(marks))]
    print(f"{tag} R3: {time.perf_counter() - t0:.3f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in phases) + ")", flush=True)
    return removal


def _train_r3_runs(tag, dev, cfg, kw, kernels, ckpt, counts,
                   marks) -> None:
    """R3's runs: the straight one (timed, its last step traced), then a
    run to step ``R3_CKPT_AT`` that writes its checkpoint into ``ckpt``
    and the restart from it to the end, held against the straight
    run."""
    import gc
    from repro_torch.launch.train import train_loop
    n, held, tokens, attn, flops, bound_ms = counts
    traced = R3_STEPS if dev.type == "cuda" else None
    with _StepTimes(trace_step=traced) as times, \
            Launches(*kernels) as run:
        state, hist = train_loop(cfg, **kw)
    ms = times.ms()
    marks.append(("the straight run", time.perf_counter()))
    peak = torch.cuda.max_memory_allocated()
    check(run.counts == (0, 0), f"step R3: a training step launched "
          f"{run.counts} sweep and dominance kernels, expected (0, 0)")
    losses = [v for _, v in hist]
    check(len(losses) == R3_STEPS and all(np.isfinite(losses)),
          f"step R3: losses {losses}")
    moved = _moved(cfg, state["params"], dev)
    check(len(moved) == 2, f"step R3: parameters that did not move: "
          f"{moved}")
    steady = ms[1:]
    step_ms = sum(steady) / len(steady)
    print(f"{tag} R3 train_loop {cfg.name} at its published widths cut to "
          f"{cfg.n_layers} of 32 layers ({held} parameters, "
          f"{held * 4} B each of f32 parameters, gradients, m and v), bf16 "
          f"compute, remat {cfg.remat}, microbatches {cfg.microbatches}, "
          f"batch {R3_BATCH} x seq {R3_SEQ} ({tokens} tokens a step), "
          f"{R3_STEPS} steps: losses {[round(v, 4) for v in losses]}; "
          f"ms a step (CUDA events; the last step traced) "
          f"{[round(t, 3) for t in ms]}, steps 2-{R3_STEPS} mean "
          f"{step_ms:.3f} ms = {tokens / step_ms * 1e3:.1f} tokens/s; "
          f"bound: {flops:.4g} FLOPs a step (6 N T = {6 * n * tokens:.4g} "
          f"with N = {n}, the parameters of the products, + full S x S "
          f"attention products {attn:.4g}, remat's recompute not counted) "
          f"at {BF16_FLOPS_PER_S / 1e12} TFLOP/s dense bf16 = "
          f"{bound_ms:.3f} ms ({step_ms / bound_ms:.2f}x the bound, model "
          f"FLOPs utilisation {bound_ms / step_ms:.3f}); peak device memory "
          f"{peak} B; launches (sweep, dominance) {run.counts}; parameters "
          f"moved: {', '.join(moved)}", flush=True)
    marks.append(("its checks", time.perf_counter()))
    if times.prof is not None:
        print_trace(times.prof, tag, f"step {R3_STEPS} of that run "
                    f"(device activity only)")
    marks.append(("the trace's report", time.perf_counter()))
    straight = state      # kept on the card (19.8 GB at yi-6b's widths)
    del state
    gc.collect()
    torch.cuda.empty_cache()

    # a checkpoint at step R3_CKPT_AT, a restart, and on to the end
    marks.append(("freeing", time.perf_counter()))
    t1 = time.perf_counter()
    with _CkptTimes() as io:
        first, _ = train_loop(cfg, **dict(kw, steps=R3_CKPT_AT),
                              ckpt_dir=ckpt, ckpt_every=R3_CKPT_AT)
    del first
    gc.collect()
    torch.cuda.empty_cache()
    marks.append(("the run to the checkpoint", time.perf_counter()))
    t2 = time.perf_counter()
    with _CkptTimes() as io2:
        resumed, _ = train_loop(cfg, **kw, ckpt_dir=ckpt,
                                ckpt_every=R3_CKPT_AT)
    t3 = time.perf_counter()
    marks.append(("the restart", time.perf_counter()))
    diffs = [(float((a.double() - b.double()).abs().max()), path)
             for (path, a), (_, b) in zip(_flat(resumed), _flat(straight))
             if not torch.equal(a, b)]
    del straight, resumed
    gc.collect()
    torch.cuda.empty_cache()
    verdict = ("bit for bit the straight run" if not diffs else
               f"{len(diffs)} leaves differ from the straight run, largest "
               f"{max(diffs)}")
    print(f"{tag} R3 checkpoint at step {R3_CKPT_AT}, restart, run to "
          f"{R3_STEPS}: {verdict} (steps 1-{R3_CKPT_AT} and the checkpoint "
          f"{t2 - t1:.3f} s; the restart: its restore, steps "
          f"{R3_CKPT_AT + 1}-{R3_STEPS} and the last checkpoint "
          f"{t3 - t2:.3f} s; checkpoint seconds {io.report()} then "
          f"{io2.report()})", flush=True)
    check(not diffs, f"step R3: the restarted run differs from the "
          f"straight run: {sorted(diffs)[-5:]}")
    marks.append(("the comparison", time.perf_counter()))


def _r4_args(ckpt: str) -> list:
    """R4's command line: the training entry point as users run it."""
    return ["repro_torch.launch.train", "--arch", "yi-6b", "--smoke",
            "--steps", "20", "--ckpt-dir", ckpt, "--ckpt-every", "5",
            "--fail-at", "7"]


def _train_r4_start():
    """Start R4 in a subprocess (it runs beside R1 and R2, which check
    numbers, not times); `_train_r4_finish` reads it."""
    import tempfile
    ckpt = tempfile.mkdtemp(prefix="r4_ckpt_")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.Popen([sys.executable, "-m", *_r4_args(ckpt)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, ckpt, time.perf_counter()


def _train_r4_finish(tag, started) -> None:
    """R4: the subprocess's exit code, its restore line and a finite
    last loss."""
    import shutil
    proc, ckpt, t0 = started
    try:
        out, err = proc.communicate(timeout=SUBPROCESS_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    lines = out.splitlines()
    if proc.returncode != 0:
        print(out[-4000:])
        print(err[-4000:], file=sys.stderr)
        fail(f"step R4: the training entry point exited {proc.returncode}")
    for line in lines:
        print(f"{tag} R4 {line}")
    check(any(ln.startswith("[train] step 7 failed (injected failure") and
              ln.endswith("restoring last checkpoint and replaying")
              for ln in lines), "step R4: no restore after the injected "
          "failure")
    m = re.search(r"\[train\] done 20 steps in .*; loss (\S+) -> (\S+)$",
                  lines[-1] if lines else "")
    check(m is not None and np.isfinite(float(m.group(2))),
          f"step R4: last line {lines[-1:]}")
    print(f"{tag} R4: {' '.join(_r4_args('<tmp>'))}: exit 0, "
          f"{time.perf_counter() - t0:.3f} s of subprocess beside R1 and R2",
          flush=True)


def _gpipe_inputs():
    l, m, b, d = R5_SHAPE
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((l, d, d)) * d ** -0.5).astype(np.float32)
    xs = rng.standard_normal((m, b, d)).astype(np.float32)
    return w, xs


def _gpipe_stage(ws, x):
    for wi in ws:
        x = torch.tanh(x @ wi)
    return x


def gpipe_rank(device) -> dict:
    """One rank of the world of four spawned by step R5: `gpipe_forward`
    over the first 2 and then all 4 ranks as stages, on ``device``
    (None: the card); ``{stages: outputs}`` where this rank is a
    stage."""
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.train.pipeline import gpipe_forward, pipeline_stages
    torch.backends.cuda.matmul.allow_tf32 = False
    w, xs = _gpipe_inputs()
    out = {}
    for stages in (2, 4):
        mesh = make_worker_mesh(stages, device=device)
        if mesh.member:
            y = gpipe_forward(_gpipe_stage, pipeline_stages(
                torch.from_numpy(w).to(mesh.device), stages),
                torch.from_numpy(xs).to(mesh.device), mesh=mesh)
            out[stages] = y.cpu().numpy()
        out["backend"], out["staged"] = mesh.backend, sorted(mesh.staged)
    return out


def _train_r5(tag, dev) -> None:
    """R5: GPipe against the sequential layers, on a NCCL world of one
    and on worlds of 2 and 4 ranks sharing the card (gloo)."""
    from repro_torch.launch.mesh import make_worker_mesh, run_world
    from repro_torch.train.pipeline import gpipe_forward, pipeline_stages
    t0 = time.perf_counter()
    _, m, b, d = R5_SHAPE
    w, xs = _gpipe_inputs()
    x = torch.from_numpy(xs).to(dev).reshape(m * b, d)
    want = _gpipe_stage(torch.from_numpy(w).to(dev), x).reshape(m, b, d)
    mesh = make_worker_mesh(1, device=dev)
    one = gpipe_forward(_gpipe_stage, pipeline_stages(
        torch.from_numpy(w).to(dev), 1), torch.from_numpy(xs).to(dev),
        mesh=mesh)
    ok, err = _close(one.cpu(), want.cpu(), 2e-5)
    check(ok, f"step R5: one stage ({mesh.backend}): error {err}")
    line = [f"W=1 ({mesh.backend}) max error {err:.3g}"]
    where = None if dev.type == "cuda" else "cpu"
    try:
        reps = run_world(gpipe_rank, 4, where, device=where,
                         deadline=TRAIN_DEADLINE_S, timeout=120.0)
    except RuntimeError as e:
        fail(f"step R5: world of 4: {e}")
    for size in (2, 4):
        outs = [r[size] for r in reps if size in r]
        check(len(outs) == size, f"step R5: W={size}: {len(outs)} stages "
              f"answered")
        check(all(np.array_equal(o.view(np.int32), outs[0].view(np.int32))
                  for o in outs), f"step R5: W={size}: the ranks differ")
        ok, err = _close(torch.from_numpy(outs[0]), want.cpu(), 2e-5)
        check(ok, f"step R5: W={size}: error {err} against the sequential "
              f"layers")
        line.append(f"W={size} (the first {size} ranks of a world of 4, "
                    f"{reps[0]['backend']}, staged "
                    f"{reps[0]['staged'] or 'none'}) max error {err:.3g}, "
                    f"every stage the same bits")
    print(f"{tag} R5 gpipe_forward (L, M, B, D) = {R5_SHAPE}, one stage "
          f"per rank of the world, against the sequential layers, rtol = "
          f"atol = 2e-5: "
          f"{'; '.join(line)} [one card shared by the ranks: a check of "
          f"the schedule, not of scaling]; {time.perf_counter() - t0:.3f} s",
          flush=True)


def train_phase(tag, kernels, dev=torch.device("cuda"),
                full_config=None) -> None:
    """Step R: training (`repro_torch.train`, `repro_torch.launch.train`)
    on the card.  R1, the ten smoke configs, one gradient and one
    ``make_train_step`` (two microbatches) each, card against the port
    on the CPU from the same numpy parameters and batch: f32 gradients
    and parameters after the step within 2e-3 of each leaf's norm
    (`_f32_updates`), bf16 per leaf within the CPU's own
    bf16 error (|card - CPU| at most max(|CPU bf16 - CPU f32|, 1e-3
    |f32|)), MoE routing replayed.  R2, yi-6b at its published widths
    with 2 layers, f32: gradients card against CPU.  R3, ``train_loop``
    at yi-6b's widths cut to 8 of 32 layers, bf16 compute, remat, 8
    microbatches, batch 8 x 4,096, ``R3_STEPS`` steps: ms a step,
    tokens/s, the FLOP bound, peak memory, the idle share of the traced
    last step, then a checkpoint at step ``R3_CKPT_AT``, a restart and
    the straight run's state.  R4,
    ``python -m repro_torch.launch.train --arch yi-6b --smoke --steps 20
    --fail-at 7`` in a subprocess.  R5, ``gpipe_forward`` against the
    sequential layers on worlds of 1 (NCCL), 2 and 4 ranks (gloo,
    sharing the card).  No kernel of the port runs here."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = torch.device("cpu")
    from repro_torch.configs import get_config
    full_config = full_config or get_config
    r4 = _train_r4_start()
    try:
        _train_r1(tag, dev, cpu)
        _train_r2(tag, dev, cpu, full_config)
    finally:
        _train_r4_finish(tag, r4)
    removal = _train_r3(tag, dev, full_config, kernels)
    try:
        _train_r5(tag, dev)
    finally:
        removal.join()
    print(f"{tag} R: {time.perf_counter() - t0:.3f} s", flush=True)


def record_dominance_calls(fn) -> list:
    """Run ``fn`` once and return the arguments of every dominance
    kernel launch it makes, for timing the calls on their own inputs.
    The launches of this run count on the recorder, not the kernel."""
    from repro_torch.kernels.dominance import kernel as dkernel
    orig = dkernel.dominated_mask_cuda
    calls = []

    def recorder(cands, refs, ref_mask, *, lower_tri=False):
        calls.append((cands, refs, ref_mask, lower_tri))
        return orig(cands, refs, ref_mask, lower_tri=lower_tri)

    recorder.launches = 0
    dkernel.dominated_mask_cuda = recorder
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        dkernel.dominated_mask_cuda = orig
    return calls


def record_sweep_calls(fn) -> list:
    """Run ``fn`` once and return the arguments of every sweep kernel
    launch it makes, for timing the calls on their own inputs.  The
    launches of this run count on the recorder, not the kernel."""
    from repro_torch.kernels.sfs import kernel
    orig = kernel.sfs_sweep_cuda
    calls = []

    def recorder(pts_s, mask_s, **kw):
        calls.append((pts_s, mask_s, kw))
        return orig(pts_s, mask_s, **kw)

    recorder.launches = 0
    kernel.sfs_sweep_cuda = recorder
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        kernel.sfs_sweep_cuda = orig
    return calls


def streaming_phase(data, oneshot, cfg, tag, kernels):
    """Ten inserts of 10^6 rows into a live state, a snapshot after each,
    on uniform and anticorrelated data; then Q = 4 states in one batched
    insert.  Returns the recorded dominance calls of the last insert and
    its launch counts, by distribution."""
    from repro_torch.core import api
    from repro_torch.kernels.sfs import kernel
    # the default config, so every insert writes its state in place; the
    # timed and traced reruns each insert into a fresh copy of the state
    # before the insert, made outside the timed span.  The kernel calls
    # are recorded with donation off, the same launches, so that the
    # recorded arguments (views of the state) keep their values
    keep = dataclasses.replace(cfg, donate=False)
    plain = dataclasses.replace(cfg, impl="torch")
    out = {}
    for dist in ("uniform", "anticorrelated"):
        x = data[dist]
        state = api.init_state(cfg, D_MAIN)
        pstate = api.init_state(plain, D_MAIN)
        for i in range(N_MAIN // CHUNK):
            chunk = x[i * CHUNK:(i + 1) * CHUNK]
            before = clone_tree(state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with Launches(*kernels) as run:
                state, stats = api.insert_chunk(state, chunk, cfg=cfg)
            t_ins = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            snap = api.finalize(state, cfg=cfg)
            torch.cuda.synchronize()
            t_fin = (time.perf_counter() - t0) * 1e3
            t_ev, _ = time_ms(lambda s: api.insert_chunk(s, chunk, cfg=cfg),
                              fresh=lambda: clone_tree(before))
            check(run.counts == (2, 2), f"streaming {dist} insert {i + 1}: "
                  f"{run.counts} sweep and dominance launches, expected "
                  f"(2, 2)")
            pstate, pstats = api.insert_chunk(pstate, chunk, cfg=plain)
            check(leaves_equal(state, pstate) and stats_equal(stats, pstats),
                  f"streaming {dist} insert {i + 1}: state or stats differ "
                  f"from impl='torch'")
            check(leaves_equal(snap, api.finalize(pstate, cfg=plain)),
                  f"streaming {dist} snapshot {i + 1} differs from "
                  f"impl='torch'")
            drops = int(stats["chunk_arrivals"]) - int(stats["n_valid"])
            print(f"{tag} streaming {dist} insert {i + 1}/{N_MAIN // CHUNK} "
                  f"({CHUNK} rows): insert {t_ins:.3f} ms (host clock; "
                  f"{t_ev:.3f} ms best of 3 by CUDA events), finalize "
                  f"{t_fin:.3f} ms; pre-filter dropped {drops}, evicted "
                  f"{int(stats['evicted'])}, inserted "
                  f"{int(stats['inserted'])}, skyline {int(state.count)}; "
                  f"launches {run.counts}; state, stats and snapshot "
                  f"bitwise equal to impl='torch'")
        check(not bool(state.overflow), f"streaming {dist}: overflow")
        check(int(state.seen) == N_MAIN
              and int(state.chunks) == N_MAIN // CHUNK,
              f"streaming {dist}: seen {int(state.seen)}, chunks "
              f"{int(state.chunks)}")
        check(leaves_equal(snap, oneshot[dist]), f"streaming {dist}: the "
              f"final snapshot differs from the one-shot parallel_skyline")
        print(f"streaming {dist} N={N_MAIN} in {N_MAIN // CHUNK} inserts: "
              f"final snapshot (skyline {int(snap.count)}) bitwise equal to "
              f"the one-shot parallel_skyline answer")
        if dist == "anticorrelated":
            trace_call(lambda s: api.insert_chunk(s, chunk, cfg=cfg), tag,
                       f"streaming {dist} insert {N_MAIN // CHUNK} "
                       f"({CHUNK} rows, donated)",
                       fresh=lambda: clone_tree(before))
        out[dist] = (record_dominance_calls(
            lambda: api.insert_chunk(before, chunk, cfg=keep)), run.counts)
        for name, (pts_p, mask_p, kw) in zip(("local", "merge"),
                                             record_sweep_calls(
            lambda: api.insert_chunk(before, chunk, cfg=keep))):
            got = kernel.sfs_sweep_cuda(pts_p, mask_p, **kw)
            t_k, _ = time_ms(lambda: kernel.sfs_sweep_cuda(pts_p, mask_p,
                                                          **kw))
            stages = time_stages(pts_p, mask_p, kw, kernel.PREFIX_ROWS, got)
            print(f"{tag} streaming {dist} insert {N_MAIN // CHUNK} "
                  f"{name} sweep call (P={pts_p.shape[0]}, npad="
                  f"{pts_p.shape[1]}, wcap={kw['wcap']}): kernel {t_k:.3f} "
                  f"ms best of 3; {stages}")

    # Q = 4 states in one batched insert against four single states
    x = data["anticorrelated"]
    q, steps, rows = 4, 4, N_MAIN // 40
    streams = [x[j * steps * rows:(j + 1) * steps * rows] for j in range(q)]
    bstate = api.init_state(cfg, D_MAIN, q=q)
    singles = [api.init_state(cfg, D_MAIN) for _ in range(q)]
    for i in range(steps):
        chunk = torch.stack([s[i * rows:(i + 1) * rows] for s in streams])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with Launches(*kernels) as run:
            bstate, _ = api.insert_chunk(bstate, chunk, cfg=cfg)
        t_batch = (time.perf_counter() - t0) * 1e3
        check(run.counts == (2, 2), f"batched insert {i + 1}: {run.counts} "
              f"launches, expected (2, 2)")
        t0 = time.perf_counter()
        for j in range(q):
            singles[j], _ = api.insert_chunk(singles[j], chunk[j], cfg=cfg)
        torch.cuda.synchronize()
        t_single = (time.perf_counter() - t0) * 1e3
        print(f"{tag} batched insert {i + 1}/{steps} of Q={q} x {rows} rows "
              f"(anticorrelated): {t_batch:.3f} ms in {run.counts} launches; "
              f"{q} single inserts {t_single:.3f} ms")
    bsnap = api.finalize(bstate, cfg=cfg)
    for j in range(q):
        check(leaves_equal([leaf[j] for leaf in bstate], singles[j])
              and leaves_equal([leaf[j] for leaf in bsnap],
                               api.finalize(singles[j], cfg=cfg)),
              f"batched insert: stream {j} differs from its single state")
    print(f"batched insert Q={q}: every state and snapshot bitwise equal to "
          f"the {q} single-state inserts (skylines "
          f"{bstate.count.tolist()})")
    return out


QUERY_OPTIONS = (  # name, config fields, expected (sweep, dominance) launches
    ("rep_filter='sorted'", dict(rep_filter="sorted"), (2, 3)),
    ("noseq=True", dict(noseq=True), (1, 1)),
)


def queries_phase(data, oneshot, cfg, tag, kernels):
    """``parallel_skyline`` with representative filtering and with NoSeq
    on every distribution.  Returns the recorded dominance calls and the
    launch counts of each query, by (distribution, option)."""
    from repro_torch.core import api, parallel
    out = {}
    for dist, x in data.items():
        mask = torch.ones((x.shape[0],), dtype=torch.bool, device=x.device)
        for name, fields, want in QUERY_OPTIONS:
            qcfg = dataclasses.replace(cfg, **fields)
            with Launches(*kernels) as run:
                buf, stats = api.parallel_skyline(x, cfg=qcfg)
            check(run.counts == want, f"{dist} {name}: {run.counts} sweep "
                  f"and dominance launches, expected {want}")
            check(leaves_equal(buf, oneshot[dist]), f"{dist} {name}: the "
                  f"result differs from the default configuration's")
            ref, rstats = api.parallel_skyline(
                x, cfg=dataclasses.replace(qcfg, impl="torch"))
            check(leaves_equal(buf, ref) and stats_equal(stats, rstats),
                  f"{dist} {name}: result or stats differ from impl='torch'")
            e2e, runs = time_ms(lambda: api.parallel_skyline(x, cfg=qcfg))
            buckets, meta, _ = parallel.partition_stage(x, mask, qcfg)
            sky, _ = parallel.local_stage(buckets.points, buckets.mask, qcfg)
            t_local, _ = time_ms(lambda: parallel.local_stage(
                buckets.points, buckets.mask, qcfg))
            t_merge, _ = time_ms(lambda: parallel.merge_stage(sky, meta,
                                                              qcfg))
            dropped = (f", rep filter dropped "
                       f"{int(stats['rep_filter_dropped'])}"
                       if "rep_filter_dropped" in stats else "")
            print(f"{tag} {name} {dist} N={N_MAIN} d={D_MAIN}: {e2e:.3f} ms "
                  f"best of 3 ({', '.join(f'{t:.3f}' for t in runs)}); local "
                  f"{t_local:.3f} ms, merge {t_merge:.3f} ms; skyline "
                  f"{int(buf.count)}{dropped}; launches {run.counts}; bitwise "
                  f"equal to the default answer and to impl='torch', stats "
                  f"included")
            if dist != "correlated":
                out[dist, name] = (record_dominance_calls(
                    lambda: api.parallel_skyline(x, cfg=qcfg)), run.counts)
    # the other representative strategies take the same launches and give
    # the same answer (random draws from a generator on the card)
    x = data["anticorrelated"]
    for strategy in ("region", "random"):
        qcfg = dataclasses.replace(cfg, rep_filter=strategy)
        with Launches(*kernels) as run:
            buf, stats = api.parallel_skyline(
                x, cfg=qcfg, generator=torch.Generator(
                    device=x.device).manual_seed(5))
        check(run.counts == (2, 3) and leaves_equal(buf, oneshot[
            "anticorrelated"]), f"rep_filter={strategy!r}: launches "
              f"{run.counts} or the answer differ")
        print(f"rep_filter={strategy!r} anticorrelated N={N_MAIN}: rep "
              f"filter dropped {int(stats['rep_filter_dropped'])}, launches "
              f"{run.counts}, bitwise equal to the default answer")
    return out


DOM_CALL_NAMES = {
    "insert": ("pre-filter", "evict"),
    "rep_filter='sorted'": ("representatives", "pool", "rep filter"),
    "noseq=True": ("noseq",),
}


def time_dominance_calls(paths, tag):
    """Kernel, plain and bound of every recorded dominance call; returns
    the sums over the anticorrelated calls and their launches."""
    from repro_torch.kernels.dominance import kernel as dkernel
    from repro_torch.kernels.dominance import ops as dops
    record = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0,
              "launches": 0, "err": 0.0}
    for (dist, path), (calls, counts) in paths.items():
        names = DOM_CALL_NAMES[path]
        check(len(calls) == len(names), f"{dist} {path}: {len(calls)} "
              f"recorded dominance calls, expected {len(names)}")
        if dist == "anticorrelated":
            record["launches"] += counts[1]
        for name, (c, r, m, lt) in zip(names, calls):
            got = dkernel.dominated_mask_cuda(c, r, m, lower_tri=lt)
            want = dops.dominated_mask_torch(c, r, m, lower_tri=lt)
            check(bits_equal(got, want), f"{dist} {path} {name} call: the "
                  f"kernel differs from the plain version")
            t_k, _ = time_ms(
                lambda: dkernel.dominated_mask_cuda(c, r, m, lower_tri=lt))
            t_p, _ = time_ms(
                lambda: dops.dominated_mask_torch(c, r, m, lower_tri=lt),
                reps=2)
            grids = time_dom_grids(c, r, m, lt, want)
            b, n, d = c.shape
            nr = r.shape[1]
            # the mask is read whole, a reference row's coordinates only
            # where it is valid: a masked row sets no bit.  Shared refs
            # (batch stride 0) are read once per row valid in some batch.
            ref_rows = int((m.any(dim=0) if r.stride(0) == 0 else m).sum())
            nbytes = (4 * b * n * d + b * n + 4 * d * ref_rows
                      + nr * (1 if m.stride(0) == 0 else b))
            compares = count_dom_compares(c, r, m, lt)
            ops_n = 2 * d * compares
            t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
            t_ops = ops_n / F32_OPS_PER_S * 1e3
            bound = max(t_bytes, t_ops)
            print(f"{tag} dominated_mask {name} call ({dist} {path}: B={b}, "
                  f"C={n}, R={nr}, d={d}, {ref_rows} valid ref rows "
                  f"read, lower_tri={lt}): kernel {t_k:.3f} ms, "
                  f"plain {t_p:.3f} ms, bound {bound:.6f} ms set by "
                  f"{'bytes' if t_bytes >= t_ops else 'operations'} "
                  f"({nbytes} bytes -> {t_bytes:.6f} ms; {compares} compares "
                  f"x 2d = {ops_n} ops -> {t_ops:.6f} ms); {grids}")
            if dist == "anticorrelated":
                record["ms"] += t_k
                record["plain_ms"] += t_p
                record["bytes"] += nbytes
                record["ops"] += ops_n
    return record


def time_dom_grids(c, r, m, lt, want) -> str:
    """The dominance kernel's two grids timed by CUDA events (best of 3
    after a warm-up, per grid), with the valid reference rows per batch
    (min-max) and whether grid 1 ran; the output must equal ``want`` bit
    for bit."""
    from repro_torch.kernels.dominance import kernel as dkernel
    runs = [dkernel.dominance_stages(c, r, m, lower_tri=lt)
            for _ in range(4)][1:]
    for out, _ in runs:
        check(bits_equal(out, want),
              "the dominance grids differ from the plain version")
    info = runs[0][1]
    best = {k: min(run[1][k] for run in runs)
            for k in ("compact_ms", "walk_ms")}
    total = min(run[1]["compact_ms"] + run[1]["walk_ms"] for run in runs)
    rows = info["valid_rows"]
    return (f"grids (tiles of {info['tile_rows']} rows): compact "
            f"{best['compact_ms']:.3f} ms, walk {best['walk_ms']:.3f} ms "
            f"(sum {total:.3f} ms, best of 3); grid 1 ran: "
            f"{info['compacted']}; valid ref rows per batch "
            f"{min(rows)}-{max(rows)}")


def sync_debug_call(calls):
    """One recorded pre-filter call under set_sync_debug_mode("error"):
    a host synchronisation in the entry raises there."""
    from repro_torch.analysis.verifier import no_sync
    from repro_torch.kernels.dominance import kernel as dkernel
    c, r, m, lt = calls[0]
    out = no_sync(lambda: dkernel.dominated_mask_cuda(c, r, m, lower_tri=lt))
    torch.cuda.synchronize()
    return out


def trace_call(fn, tag: str, label: str, fresh):
    """``fn(fresh())`` traced once by torch.profiler after a warm-up,
    ``fresh()`` made before the trace: prints the eight device
    operations that took the most time and the device's idle share over
    the traced window (from the first event to the last, host or
    device) and over the device span alone (from the first device
    operation to the end of the last)."""
    from torch.profiler import ProfilerActivity, profile
    fn(fresh())
    arg = fresh()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(arg)
        torch.cuda.synchronize()
    print_trace(prof, tag, label)


def print_trace(prof, tag: str, label: str) -> None:
    """The device's idle share and top eight operations of a finished
    torch.profiler session (see `trace_call`)."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == DeviceType.CUDA)
    if not dev:
        print(f"{tag} trace of {label}: the profiler recorded no device "
              f"events; device idle share not measured")
        return
    start = min(e.time_range.start for e in events)
    end = max(e.time_range.end for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    by_name = {}
    for s, e, name in dev:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + (e - s), n + 1)
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = end - start
    span = max(e for _, e, _ in dev) - dev[0][0]
    print(f"{tag} trace of {label}: window {window / 1e3:.3f} ms, device "
          f"busy {busy / 1e3:.3f} ms in {len(dev)} device operations, idle "
          f"share {1 - busy / window:.4f} of the window; over the device "
          f"span alone (first device operation's start to the last's end, "
          f"{span / 1e3:.3f} ms) idle share {1 - busy / span:.4f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for rank, (name, (tot, n)) in enumerate(top, 1):
        print(f"{tag} trace of {label}, device operation {rank}: "
              f"{tot / 1e3:.3f} ms in {n} call(s) "
              f"({tot / window:.4f} of the window): {name[:160]}")


def count_dom_compares(cands, refs, ref_mask, lower_tri: bool) -> int:
    """The compares the dominance test needs on these inputs: for every
    candidate, the valid references (with j < i under lower_tri) up to
    and including its first dominator, or all of them when none
    dominates it.  Blocked as the plain version is; the main path never
    calls this."""
    from repro_torch.kernels.dominance import ops as dops
    b, c, d = cands.shape
    r = refs.shape[1]
    if c == 0 or r == 0:
        return 0
    dev = cands.device
    valid = torch.cat([torch.zeros((b, 1), dtype=torch.int64, device=dev),
                       torch.cumsum(ref_mask.to(torch.int64), dim=1)], 1)
    first = torch.full((b, c), r, dtype=torch.int64, device=dev)
    # rows past the last valid one are neither compared nor dominators
    r_end = dops._last_valid_row(ref_mask)
    rb = dops._REF_BLOCK
    cb = max(1, dops._PAIR_BUDGET // (b * rb))
    for c0 in range(0, c, cb):
        c1 = min(c0 + cb, c)
        x = cands[:, c0:c1, None, :]
        f = first[:, c0:c1]
        for r0 in range(0, r_end, rb):
            r1 = min(r0 + rb, r_end)
            y = refs[:, None, r0:r1, :]
            le = y[..., 0] <= x[..., 0]
            lt = y[..., 0] < x[..., 0]
            for k in range(1, d):
                le &= y[..., k] <= x[..., k]
                lt |= y[..., k] < x[..., k]
            dom = le & lt & ref_mask[:, None, r0:r1]
            if lower_tri:
                j = torch.arange(r0, r1, device=dev)
                i = torch.arange(c0, c1, device=dev)
                dom &= j[None, :] < i[:, None]
            idx = dom.to(torch.uint8).argmax(dim=-1) + r0
            f.copy_(torch.where(dom.any(dim=-1) & (f == r), idx, f))
    found = first < r
    upto = valid.gather(1, torch.where(found, first + 1, 0))
    if lower_tri:
        limit = torch.arange(c, device=dev).clamp(max=r).expand(b, c)
        none = valid.gather(1, limit)
    else:
        none = valid[:, r:].expand(b, c)
    return int(torch.where(found, upto, none).sum())


T_START = time.perf_counter()


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA "
             "card")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import api, datagen, parallel, sfs
    from repro_torch.core.dominance import SENTINEL
    from repro_torch.kernels import build
    from repro_torch.kernels.dominance import kernel as dkernel
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
    for lib in ("sfs_sweep", "dominated_mask"):
        props = ptxas_report(build.build_log(lib))
        check(bool(props), f"no -Xptxas -v report in the {lib} build log")
        for name, d_inst in sorted(props):
            p = props[name, d_inst]
            law = ("; " + smem_law(kernel, name, d_inst)
                   if lib == "sfs_sweep"
                   else dom_smem_law(dkernel, name, d_inst))
            print(f"ptxas {name}<D={d_inst}>: {p.get('used', '?')}, "
                  f"{p.get('spills', '?')}{law}")
    print(f"{tag} {sass_ftz_report(libs)}")

    # a quicker run: the build, then the engine step or the serve step
    if "--tuning-only" in sys.argv[1:]:
        kernels = (kernel.sfs_sweep_cuda, dkernel.dominated_mask_cuda)
        launch_phase(tag, tuning_phase(tag, kernels))
        pareto_phase(tag, kernels)
        print(f"--tuning-only: stopped after steps T, L and P; "
              f"chip_smoke.py ran {time.perf_counter() - T_START:.3f} s")
        return
    if "--lm-only" in sys.argv[1:]:
        lm_phase(tag)
        print(f"--lm-only: stopped after step G; chip_smoke.py ran "
              f"{time.perf_counter() - T_START:.3f} s")
        return
    if "--train-only" in sys.argv[1:]:
        train_phase(tag, (kernel.sfs_sweep_cuda, dkernel.dominated_mask_cuda))
        print(f"--train-only: stopped after step R; chip_smoke.py ran "
              f"{time.perf_counter() - T_START:.3f} s")
        return
    for flag, phase in (("--engine-only", engine_phase),
                        ("--serve-only", serve_phase),
                        ("--verify-only", verify_phase),
                        ("--mesh-only", mesh_phase)):
        if flag in sys.argv[1:]:
            phase(tag, (kernel.sfs_sweep_cuda, dkernel.dominated_mask_cuda))
            print(f"{flag}: stopped after that step; chip_smoke.py ran "
                  f"{time.perf_counter() - T_START:.3f} s")
            return

    # -- 3. kernel against the plain version, bit for bit -------------------
    max_err = sweep_cases(dev)
    dom_err = dominance_cases(dev)
    sub_err = subnormal_cases(dev)
    many_err = many_parts_cases(dev)
    max_err = max(max_err, sub_err, many_err)
    dom_err = max(dom_err, sub_err, many_err)
    print(f"dominance kernel: max_abs_err {dom_err} over the kernel cases")
    if "--kernels-only" in sys.argv[1:]:
        print("--kernels-only: stopped after the kernel cases")
        return

    # -- 4. the main path on the card ---------------------------------------
    kernels = (kernel.sfs_sweep_cuda, dkernel.dominated_mask_cuda)
    cfg = parallel.SkyConfig(capacity=65536)
    plain = dataclasses.replace(cfg, impl="torch")
    data = {}
    oneshot = {}
    launches = {}
    sky_size = {}
    for seed, dist in enumerate(("uniform", "correlated", "anticorrelated")):
        gen = torch.Generator(device=dev).manual_seed(1000 + seed)
        x = datagen.generate(dist, gen, N_MAIN, D_MAIN)
        data[dist] = x
        with Launches(*kernels) as run:
            buf, stats = api.parallel_skyline(x, cfg=cfg)
        oneshot[dist] = buf
        launches[dist] = run.counts[0]
        check(run.counts == (2, 0), f"{dist}: {run.counts} sweep and "
              f"dominance launches, expected (2, 0)")
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

    # subnormals: the witness keeps its three members on the card
    wit, _ = api.parallel_skyline(torch.tensor(WITNESS, device=dev))
    check(int(wit.count) == 3, f"the subnormal witness has {int(wit.count)} "
          f"members on the card, expected 3")
    print("subnormal witness (1e-40, 1), (2e-40, 1), (0.5, 0.5): 3 members "
          "on the card, as in the JAX package")
    flush_cost(data["anticorrelated"], tag)

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

    # -- 5-6. streaming, then representative filtering and NoSeq -------------
    dom_paths = {}
    for dist, rec in streaming_phase(data, oneshot, cfg, tag,
                                     kernels).items():
        dom_paths[dist, "insert"] = rec
    dom_paths.update(queries_phase(data, oneshot, cfg, tag, kernels))
    calls, _ = dom_paths["anticorrelated", "insert"]
    got = sync_debug_call(calls)
    c, r, m, lt = calls[0]
    check(bits_equal(got, dkernel.dominated_mask_cuda(c, r, m, lower_tri=lt)),
          "the pre-filter call under sync debug mode differs")
    print("pre-filter call (anticorrelated) under "
          "torch.cuda.set_sync_debug_mode('error'): no host sync raised")

    # -- 7. times -----------------------------------------------------------
    def sweep_calls(x):
        """The two sweep calls of one query, with their inputs."""
        mask = torch.ones((x.shape[0],), dtype=torch.bool, device=dev)
        buckets, _, _ = parallel.partition_stage(x, mask, cfg)
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
        buckets, meta, _ = parallel.partition_stage(x, mask, cfg)
        sky, _ = parallel.local_stage(buckets.points, buckets.mask, cfg)
        t_part, _ = time_ms(lambda: parallel.partition_stage(x, mask, cfg))
        t_local, _ = time_ms(
            lambda: parallel.local_stage(buckets.points, buckets.mask, cfg))
        t_merge, _ = time_ms(lambda: parallel.merge_stage(sky, meta, cfg))
        print(f"{tag} stages of one {dist} query N={N_MAIN} d={D_MAIN}: "
              f"partition {t_part:.3f} ms, local {t_local:.3f} ms, merge "
              f"{t_merge:.3f} ms")
        for call, (pts_p, mask_p, blk, wcap) in sweep_calls(x).items():
            kw = dict(block=blk, wcap=wcap, sentinel=SENTINEL)
            t_k, _ = time_ms(lambda: ops.sfs_sweep(pts_p, mask_p,
                                                   spec="cuda", **kw))
            t_p, _ = time_ms(lambda: ops.sfs_sweep(pts_p, mask_p,
                                                   spec="torch", **kw))
            got = ops.sfs_sweep(pts_p, mask_p, spec="cuda", **kw)
            prefixes = [kernel.PREFIX_ROWS]
            if call == "local" and dist == "anticorrelated":
                prefixes += PREFIX_TABLE    # K = 4, 64 and 256 blocks
            for pre in prefixes:
                print(f"{tag} sfs_sweep {call} call ({dist}) "
                      f"{time_stages(pts_p, mask_p, kw, pre, got)}")
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
    dom = time_dominance_calls(dom_paths, tag)

    # -- 6b. the other strategies, windows and the real datasets, after the
    # kernel times above, so that those are taken as in earlier runs
    strategies_phase(data, oneshot, cfg, tag, kernels)
    windows_phase(data, cfg, tag, kernels)
    real_data_phase(cfg, tag, kernels)
    engine_phase(tag, kernels)
    print(f"peak device memory {torch.cuda.max_memory_allocated()} bytes")
    serve_phase(tag, kernels)
    verify_phase(tag, kernels)
    mesh_phase(tag, kernels, data)
    t_tlp = time.perf_counter()
    launch_phase(tag, tuning_phase(tag, kernels, data))
    pareto_phase(tag, kernels)
    print(f"{tag} steps T, L and P: {time.perf_counter() - t_tlp:.3f} s")
    del data, oneshot
    lm_phase(tag)
    train_phase(tag, kernels)

    # -- 8. the kernel record and the device line ----------------------------
    def entry(name, route, source, replaces, launches_n, err, rec):
        t_bytes = rec["bytes"] / MEM_BYTES_PER_S * 1e3
        t_ops = rec["ops"] / F32_OPS_PER_S * 1e3
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": launches_n,
                "max_abs_err": err, "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None}

    print(f"{tag} kernel record: sfs_sweep's launches, ms, plain_ms and "
          f"bound_ms are those of one anticorrelated N={N_MAIN} query "
          f"(local + merge calls; launches per query {launches}); "
          f"dominated_mask's are those of one anticorrelated streaming "
          f"insert (pre-filter + evict), one rep_filter='sorted' query "
          f"(3 calls) and one noseq=True query (1 call) added; library_ms is "
          f"null: no single PyTorch call computes an SFS sweep or a "
          f"dominated mask")
    print(f"{tag} chip_smoke.py ran {time.perf_counter() - T_START:.3f} s, "
          f"the kernels' build included")
    print(json.dumps({"kernels": [
        entry("sfs_sweep", "cuda", SOURCE, REPLACES,
              launches["anticorrelated"], max_err, record),
        entry("dominated_mask", "cuda", DOM_SOURCE, DOM_REPLACES,
              dom["launches"], dom_err, dom)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu, "count": torch.cuda.device_count()}}))


PREFIX_TABLE = (1024, 16384, 65536)   # other prefixes timed beside 4096


def time_stages(pts_p, mask_p, kw, prefix: int, want) -> str:
    """The sweep's three grids timed by CUDA events (best of 3 after a
    warm-up, per grid), with stage A's count, B's survivors and C's
    branch per partition; the output must equal ``want`` bit for bit."""
    from repro_torch.kernels.sfs import kernel
    runs = [kernel.sweep_stages(pts_p, mask_p, prefix=prefix, **kw)
            for _ in range(4)][1:]
    for out, _ in runs:
        check(leaves_equal(out, want), f"the sweep with a prefix of {prefix} "
              f"rows differs from the entry's output")
    info = runs[0][1]
    best = {k: min(r[1][k] for r in runs) for k in ("a_ms", "b_ms", "c_ms")}
    total = min(r[1]["a_ms"] + r[1]["b_ms"] + r[1]["c_ms"] for r in runs)
    branch = ["packed" if b else "original" if b is not None else "A only"
              for b in info["packed"]]
    return (f"stages at a prefix of {info['prefix_rows']} rows: A "
            f"{best['a_ms']:.3f} ms, B {best['b_ms']:.3f} ms, C "
            f"{best['c_ms']:.3f} ms (sum {total:.3f} ms, best of 3); c_A "
            f"{info['c_a']}, survivors {info['survivors']}, C {branch}; "
            f"bitwise equal to the entry's output")


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
