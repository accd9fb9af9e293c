"""A gloo world of CPU ranks for the port's mesh tests.

``World(size, tmpdir)`` spawns ``size`` processes joined into one gloo
world through a ``FileStore`` under ``tmpdir`` (never a TCP port), and
keeps them for the tests of a file (`repro_torch.launch.mesh.World`):
``world.run(task, *args)`` runs ``task`` (the name of a function of this
module) in every rank with the same arguments and returns each rank's
result, in rank order.  Every group has a timeout and every run a
deadline: a rank that fails or hangs fails the run, and a hung world is
killed, never left to hang the suite.

This module imports only torch, numpy and ``repro_torch``, so that the
children never import JAX.  The tasks take and return numpy arrays.
"""

from __future__ import annotations

import os
import time

import numpy as np

from repro_torch.launch.mesh import World as _MeshWorld

GROUP_TIMEOUT_S = 40.0
DEADLINE_S = 100.0


class World(_MeshWorld):
    """`repro_torch.launch.mesh.World` of CPU ranks whose tasks are named
    by the functions of this module."""

    def __init__(self, size: int, tmpdir, *,
                 group_timeout: float = GROUP_TIMEOUT_S):
        super().__init__(size, os.path.join(str(tmpdir), "store"),
                         device="cpu", timeout=group_timeout)

    def run(self, task: str, *args, deadline: float = DEADLINE_S) -> list:
        """``task(*args)`` in every rank; each rank's result by rank."""
        return super().run(globals()[task], *args, deadline=deadline)


# --------------------------------------------------------------------------
# tasks (run in every rank)
# --------------------------------------------------------------------------

def _leaves(tree) -> list[np.ndarray]:
    return [x.detach().cpu().numpy().copy() for x in tree]


def _cfg(kw: dict):
    from repro_torch.core.parallel import SkyConfig
    return SkyConfig(**kw)


def _feed_ids(ids):
    """Make ``random_part_ids`` return the given arrays in turn (the
    reference's ids, ROADMAP.md contract 5); returns the undo."""
    from repro_torch.core import partition
    import torch
    left = [np.asarray(a) for a in ids]
    orig = partition.random_part_ids

    def fed(generator, n, p, *, device=None):
        return torch.from_numpy(left.pop(0)).to(device)

    partition.random_part_ids = fed
    return lambda: setattr(partition, "random_part_ids", orig)


def collectives(workers: int):
    """The mesh's collectives on a prefix mesh of ``workers`` ranks:
    all_gather order, a partial ppermute, the bit-exact root broadcast
    (``-0.0`` and a NaN payload) and the integer psum."""
    import torch
    from repro_torch.launch.mesh import make_worker_mesh
    m = make_worker_mesh(workers, device="cpu")
    if not m.member:
        return None
    w = m.w_index
    x = torch.tensor([[float(w), -0.0]])
    nan = torch.tensor([0x7FC01234], dtype=torch.int32).view(torch.float32)
    root = torch.cat([torch.tensor([-0.0, 1.5]), nan]) if w == 0 \
        else torch.full((3,), float(w))
    pairs = [(i + 1, i) for i in range(0, workers - 1, 2)]
    return {
        "gather": m.all_gather(x, dim=0).numpy(),
        "gather1": m.all_gather(torch.tensor([[w == 1, True]]), dim=1).numpy(),
        "ppermute": m.ppermute(torch.tensor([w + 0.5, -0.0]), pairs).numpy(),
        "bcast": m.broadcast_from_root(root).view(torch.int32).numpy(),
        "psum": m.psum(torch.tensor([w, 1], dtype=torch.int32)).numpy(),
        "index": (m.w_index, m.q_index, m.workers, m.queries)}


def hang(workers: int):
    """Rank 0 waits in an all_gather that rank 1 never joins: the group's
    timeout must fail it."""
    import torch
    from repro_torch.launch.mesh import make_worker_mesh
    m = make_worker_mesh(workers, device="cpu", timeout=3.0)
    if m.w_index == 0:
        t0 = time.monotonic()
        try:
            m.all_gather(torch.zeros(2))
        except Exception as e:  # the timeout is what is tested
            return ("raised", type(e).__name__, time.monotonic() - t0)
        return ("returned", None, time.monotonic() - t0)
    time.sleep(5.0)
    return ("idle", None, 0.0)


def skyline_cases(workers: int, cases: list) -> list | None:
    """``parallel_skyline`` on a prefix mesh of ``workers`` ranks for
    each case ``{pts, mask, cfg, ids}``; returns each buffer's leaves,
    with the one-device answer's beside them."""
    from repro_torch.core.parallel import parallel_skyline
    from repro_torch.launch.mesh import make_worker_mesh
    m = make_worker_mesh(workers, device="cpu")
    if not m.member:
        return None
    out = []
    for c in cases:
        cfg = _cfg(c["cfg"])
        got = []
        for mesh in (m, None):
            undo = _feed_ids(c.get("ids", []))
            try:
                buf, _ = parallel_skyline(c["pts"], c.get("mask"), cfg=cfg,
                                          mesh=mesh, device="cpu")
            finally:
                undo()
            got.append(_leaves(buf))
        out.append(got)
    return out


def stream_case(workers: int, pts, chunk: int, cfg_kw: dict, batched_q):
    """Chunked inserts on a mesh of ``workers`` and the one-shot answer
    on the same mesh, with the one-device one-shot answer beside them;
    ``batched_q`` > 0 runs Q states on a (batched_q x
    workers/batched_q) mesh instead."""
    import torch
    from repro_torch.core import incremental as inc
    from repro_torch.core.parallel import fused_skyline_batch_fn
    from repro_torch.core.parallel import parallel_skyline
    from repro_torch.launch.mesh import make_engine_mesh, make_worker_mesh
    cfg = _cfg(cfg_kw)
    if batched_q:
        m = make_engine_mesh(batched_q, workers // batched_q, device="cpu")
    else:
        m = make_worker_mesh(workers, device="cpu")
    if not m.member:
        return None
    pts = torch.from_numpy(pts)
    d = pts.shape[-1]
    if batched_q:
        q = pts.shape[0]
        valid = torch.ones(pts.shape[:2], dtype=torch.bool)
        one, _ = fused_skyline_batch_fn(cfg, m)(pts, valid)
        solo, _ = fused_skyline_batch_fn(cfg)(pts, valid)
        state = inc.init_state(cfg, d, q=q, device="cpu")
        for lo in range(0, pts.shape[1], chunk):
            state, _ = inc.insert_chunk(state, pts[:, lo:lo + chunk],
                                        cfg=cfg, mesh=m)
    else:
        one, _ = parallel_skyline(pts, cfg=cfg, mesh=m)
        solo, _ = parallel_skyline(pts, cfg=cfg, device="cpu")
        state = inc.init_state(cfg, d, device="cpu")
        for lo in range(0, pts.shape[0], chunk):
            state, _ = inc.insert_chunk(state, pts[lo:lo + chunk], cfg=cfg,
                                        mesh=m)
    return (_leaves(one), _leaves(inc.finalize(state, cfg=cfg)),
            _leaves(solo))


def window_case(workers: int, chunks: list, epochs: int, cfg_kw: dict,
                advance_after: list):
    """A window fed ``chunks`` on a mesh of ``workers`` (advancing the
    ring after the chunk indices in ``advance_after``); returns every
    leaf after each insert, and the final snapshot."""
    import torch
    from repro_torch.core import windowed as win
    from repro_torch.launch.mesh import make_worker_mesh
    cfg = _cfg(cfg_kw)
    m = make_worker_mesh(workers, device="cpu")
    if not m.member:
        return None
    d = chunks[0].shape[-1]
    st = win.init_window_state(cfg, d, epochs=epochs, device="cpu")
    trace = []
    for i, c in enumerate(chunks):
        st, _ = win.insert_chunk(st, torch.from_numpy(c), cfg=cfg, mesh=m)
        trace.append(_leaves(st))
        if i in advance_after:
            st, _ = win.advance_epoch(st)
    _, front, _ = win.window_tick(st, torch.from_numpy(chunks[0]), cfg=cfg,
                                  advance=torch.tensor(True), mesh=m)
    return trace, _leaves(win.finalize(st, cfg=cfg, mesh=m)), _leaves(front)


def engine_case(queries: int, workers: int, items: list, cfg_kw: dict,
                threshold: int, masks=None):
    """The sharded engine on a (queries x workers) mesh against the
    one-device engine, on ragged ``items``; returns both answers, the
    sharded engine's dispatch counters and its stream snapshots."""
    from repro_torch.launch.mesh import make_engine_mesh
    from repro_torch.serve.api import SkylineRequest, StreamOptions
    from repro_torch.serve.engine import SkylineEngine
    cfg = _cfg(cfg_kw)
    m = make_engine_mesh(queries, workers, device="cpu")
    if not m.member:
        return None
    masks = masks or [None] * len(items)
    reqs = [SkylineRequest(data=x, mask=mk, key=10 + i)
            for i, (x, mk) in enumerate(zip(items, masks))]
    plain = SkylineEngine(cfg, min_n_bucket=64, device="cpu")
    sharded = SkylineEngine(cfg, min_n_bucket=64, mesh=m,
                            shard_threshold_n=threshold)
    got = [(_leaves(b), int(s["n_valid"]))
           for b, s in sharded.submit_many(reqs)]
    want = [(_leaves(b), int(s["n_valid"]))
            for b, s in plain.submit_many(reqs)]
    streams = []
    for eng in (sharded, plain):
        st = eng.open_stream(items[0].shape[1], StreamOptions(q=len(items)))
        for lo in (0, 64):
            st.feed([x[lo:lo + 64] for x in items])
        streams.append([_leaves(b) for b in st.drain().snapshot()])
        st.close()
    return {"got": got, "want": want, "streams": streams,
            "sharded": sharded.sharded_dispatched,
            "batches": sharded.batches_dispatched}


def calibrate_case(queries: int, workers: int, cfg_kw: dict, sizes: list):
    """`calibrate_shard_threshold` on a (queries x workers) engine mesh:
    the report, the stored factorings, and the mesh a calibrated bucket
    routes through."""
    from repro_torch.launch.mesh import make_engine_mesh
    from repro_torch.serve.engine import (SkylineEngine,
                                          calibrate_shard_threshold)
    m = make_engine_mesh(queries, workers, device="cpu")
    if not m.member:
        return None
    eng = SkylineEngine(_cfg(cfg_kw), mesh=m, min_n_bucket=64)
    rep = calibrate_shard_threshold(eng, bucket_sizes=tuple(sizes),
                                    repeat=1)
    routed = {nb: (eng._mesh_for(nb).queries, eng._mesh_for(nb).workers)
              for nb in eng.factorings}
    return rep, dict(eng.factorings), routed


def verify_cells(names, negative: str | None = None):
    """The program verifier on this rank over ``names``; ``negative``
    breaks the program first: ``'queries'`` adds an all_gather over the
    queries group to the tree merge, ``'round'`` one ppermute round too
    many, ``'flat'`` runs the flat union in tree mode."""
    from repro_torch.analysis.verifier import verify_programs
    from repro_torch.core import parallel as par
    undo = _break(par, negative)
    try:
        report, errors = verify_programs(names, device="cpu")
    finally:
        undo()
    return report, errors


def _break(par, negative):
    """Install one of `verify_cells`' faults; returns the undo."""
    if negative is None:
        return lambda: None
    orig = par._tree_merge
    if negative == "flat":
        def broken(sky, cfg, *, part_idx, cells, shard):
            import dataclasses
            final, s3 = par.merge_stage(
                sky, {"part_idx": part_idx, "cells": cells, "p": 0, "m": 0},
                dataclasses.replace(cfg, merge="flat"), shard=shard)
            return final, s3["union_size"]
    else:
        def broken(sky, cfg, *, part_idx, cells, shard):
            mesh = shard.mesh
            if negative == "queries":
                mesh.all_gather(sky.count, dim=0, axis=mesh.q_axis)
            else:
                mesh.ppermute(sky.count, [])
            return orig(sky, cfg, part_idx=part_idx, cells=cells,
                        shard=shard)
    par._tree_merge = broken
    return lambda: setattr(par, "_tree_merge", orig)


def routing_case(queries: int, workers: int, small, large, threshold: int):
    """Threshold routing on a (queries x workers) engine: buckets below
    ``threshold`` run on one device, buckets at or above it sharded."""
    from repro_torch.core.parallel import SkyConfig
    from repro_torch.launch.mesh import make_engine_mesh
    from repro_torch.serve.engine import SkylineEngine
    m = make_engine_mesh(queries, workers, device="cpu")
    if not m.member:
        return None
    cfg = SkyConfig(strategy="sliced", p=8, capacity=512, block=64,
                    bucket_factor=4.0)
    out = {}
    eng = SkylineEngine(cfg, mesh=m, min_n_bucket=64,
                        shard_threshold_n=threshold)
    eng.run(small)
    out["small"] = eng.sharded_dispatched
    eng.run(large)
    out["large"] = eng.sharded_dispatched
    eng2 = SkylineEngine(cfg, mesh=m, min_n_bucket=64,
                         shard_threshold_n=threshold)
    out["mixed"] = (len(eng2.run(small + large)), eng2.sharded_dispatched,
                    eng2.batches_dispatched)
    return out


def default_engine_case():
    """The scheduler's default engine in a world of several ranks."""
    from repro_torch.core.parallel import SkyConfig
    from repro_torch.serve.scheduler import make_default_engine
    eng = make_default_engine(SkyConfig(p=4), device="cpu")
    return eng.mesh.queries, eng.mesh.workers


def gpipe_case(workers: int, w, xs, kind: str):
    """`repro_torch.train.pipeline.gpipe_forward` on a prefix mesh of
    ``workers`` stages over the (L, D, D) weights ``w`` and the (M, B, D)
    microbatches ``xs``: each layer ``tanh(x @ w_i)`` (``kind="tanh"``)
    or ``-|x @ w_i| * 0`` (``"negzero"``, every output -0.0)."""
    import torch
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.train.pipeline import gpipe_forward, pipeline_stages
    m = make_worker_mesh(workers, device="cpu")
    if not m.member:
        return None

    def stage_fn(ws, x):
        for wi in ws:
            y = x @ wi
            x = torch.tanh(y) if kind == "tanh" else -torch.abs(y) * 0.0
        return x

    out = gpipe_forward(stage_fn, pipeline_stages(torch.from_numpy(w),
                                                  workers),
                        torch.from_numpy(xs), mesh=m)
    return out.numpy().copy()
