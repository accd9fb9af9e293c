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


def cardgloo_collectives():
    """Each collective of `CardGloo` on host tensors, over a group of the
    whole world made with the ``cardgloo`` backend and over the world's
    own gloo group: (cardgloo's results, gloo's), as numpy."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    import repro_torch.launch.mesh  # noqa: F401  (registers cardgloo)
    size, rank = dist.get_world_size(), dist.get_rank()
    card = dist.new_group(list(range(size)), backend="cardgloo")

    def run(group):
        x = torch.arange(2 * size, dtype=torch.float32) + 100 * rank
        out = {}
        whole = torch.empty(2 * size * size)
        dist.all_gather_into_tensor(whole, x, group=group)
        out["all_gather_into_tensor"] = whole
        out["functional_all_gather"] = funcol.all_gather_tensor(
            x, 0, group).wait()
        a, b = torch.empty_like(whole), torch.empty_like(whole)
        with dist._coalescing_manager(group=group):
            dist.all_gather_into_tensor(a, x, group=group)
            dist.all_gather_into_tensor(b, -x, group=group)
        out["all_gather_coalesced"] = torch.cat([a, b])
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        out["all_gather"] = torch.cat(parts)
        y = x.clone()
        dist.all_reduce(y, group=group)
        out["all_reduce"] = y
        shard = torch.empty(2)
        dist.reduce_scatter_tensor(shard, x, group=group)
        out["reduce_scatter_tensor"] = shard
        out["functional_reduce_scatter"] = funcol.reduce_scatter_tensor(
            x, "sum", 0, group).wait()
        moved = torch.empty_like(x)
        dist.all_to_all_single(moved, x, group=group)
        out["all_to_all_single"] = moved
        y = x.clone()
        dist.broadcast(y, 0, group=group)
        out["broadcast"] = y
        got = torch.zeros_like(x)
        calls = []
        if rank + 1 < size:
            calls.append(lambda: dist.send(x, rank + 1, group=group))
        if rank > 0:
            calls.append(lambda: dist.recv(got, rank - 1, group=group))
        for call in (calls if rank % 2 == 0 else calls[::-1]):
            call()
        out["send_recv"] = got
        dist.barrier(group=group)
        return {k: v.numpy().copy() for k, v in out.items()}

    return run(card), run(dist.group.WORLD)


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


# --------------------------------------------------------------------------
# the model side's sharding (DTensor over a (data, model) mesh)
# --------------------------------------------------------------------------

def _flat(tree, prefix=""):
    """``{path: numpy}`` of a nest of dicts of tensors (DTensors whole;
    None leaves, a gradient the loss does not reach, left out)."""
    from repro_torch.launch.mesh import DTensor
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if tree is None:
        return {}
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    return {prefix: tree.detach().float().numpy().copy()}


def sharded_train_step(arch: str, data: int, model: int, kw: dict,
                       seed: int = 0):
    """One train step of the smoke config ``arch`` (fields ``kw``
    replaced) on a (data, model) mesh of this world, and the same step
    on one rank: (loss unsharded, loss sharded, params unsharded,
    params sharded, the sharded parameters' placements) from rank 0."""
    import dataclasses
    import torch
    from repro_torch.configs import arch_rules, get_config
    from repro_torch.data.pipeline import DataState, make_batch
    from repro_torch.launch.mesh import make_local_mesh, set_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import init_state, make_train_step

    cfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    opt = OptConfig(total_steps=10, warmup_steps=1)
    params = init_params(T.lm_plan(cfg), seed=seed, device="cpu")
    batch = make_batch(cfg, 8, 64, DataState(0, 0), device="cpu")
    copy = T.tree_map(torch.clone, params)
    s1, m1 = make_train_step(cfg, opt)(init_state(params, opt), batch)
    mesh = make_local_mesh(data, model, device="cpu")
    rules = arch_rules(cfg, "train_4k", model_axis=model, data_axis=data)
    with set_mesh(mesh):
        step = make_train_step(cfg, opt, rules=rules, shard_activations=True)
        s2, m2 = step(init_state(copy, opt), batch)
    placed = {k: str(v.placements) for k, v in _flat_dt(s2["params"]).items()}
    out = (float(m1["loss"]), float(m2["loss"]), _flat(s1["params"]),
           _flat(s2["params"]), placed)
    return out if mesh.get_rank() == 0 else None


def elastic_restore(arch: str, ckpt_dir: str):
    """The smoke config's parameters saved under ``ckpt_dir``, restored
    onto a 2 x 2 (data, model) mesh by the train_4k rules: (whole
    leaves, this rank's local shards, placements, mesh coordinate)."""
    from repro_torch.checkpoint.manager import restore
    from repro_torch.configs import arch_rules, get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.common import abstract_params, plan_pspecs
    from repro_torch.sharding import named_shardings

    cfg = get_config(arch, smoke=True)
    plan = T.lm_plan(cfg)
    mesh = make_local_mesh(2, 2, device="cpu")
    rules = arch_rules(cfg, "train_4k", model_axis=2, data_axis=2)
    sh = named_shardings(plan_pspecs(plan, rules), mesh)
    target = T.tree_map(lambda t: torch_empty_like(t),
                        abstract_params(plan))
    got, step, _ = restore(ckpt_dir, target, shardings=sh)
    assert step == 1
    dts = _flat_dt(got)
    local = {k: _bits(v.to_local()) for k, v in dts.items()}
    whole = {k: _bits(v.full_tensor()) for k, v in dts.items()}
    placed = {k: str(v.placements) for k, v in dts.items()}
    return whole, local, placed, list(mesh.get_coordinate())


def torch_empty_like(t):
    import torch
    return torch.empty(t.shape, dtype=t.dtype)


def _bits(t) -> np.ndarray:
    return t.detach().contiguous().numpy().copy()


def _flat_dt(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_dt(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def distributed_moe(arch: str, host: dict, x, idx, rules: dict):
    """The smoke config ``arch``'s MoE layer (parameters ``host``, f32)
    on ``x`` (B, S, D) with the recorded routing ``idx`` (T, k), sharded
    by ``rules`` on a 2 x 2 (data, model) mesh: (output and aux, whole;
    this rank's dispatch buffer, dest and ok; its mesh coordinate)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import distribute_tensor, make_local_mesh
    from repro_torch.models import moe as tmoe
    from repro_torch.models.common import Sharder, placements, plan_pspecs

    cfg = get_config(arch, smoke=True)
    mesh = make_local_mesh(2, 2, device="cpu")
    sharder = Sharder(rules, enabled=True, mesh=mesh)
    plan = tmoe.moe_plan(cfg.d_model, cfg.d_ff, cfg.n_experts,
                         cfg.shared_expert)
    specs = plan_pspecs(plan, rules)

    def place(tree, spec):
        if isinstance(tree, dict):
            return {k: place(tree[k], spec[k]) for k in tree}
        return distribute_tensor(torch.from_numpy(tree), mesh,
                                 placements(spec, mesh), src_data_rank=None)

    params = place(host, specs)
    xs = sharder.place(torch.from_numpy(x), "batch", "seq", "act_embed")
    # this rank's token shard takes its rows of the recorded routing
    shards = 2 if rules["batch"] else 1
    me = mesh.get_coordinate()[0] if shards > 1 else 0
    rows = idx.shape[0] // shards
    mine = torch.from_numpy(idx[me * rows:(me + 1) * rows].astype(np.int64))
    seen = {}
    orig_dispatch = tmoe.moe_dispatch

    def dispatch(*a, **kw):
        out = orig_dispatch(*a, **kw)
        seen["local"] = [t.detach().clone() for t in out]
        return out

    tmoe.topk_order = lambda merit: mine
    tmoe.moe_dispatch = dispatch
    from repro_torch.launch.mesh import implicit_replication
    with implicit_replication():
        out, aux = tmoe.moe_apply(params, xs, n_experts=cfg.n_experts,
                                  top_k=cfg.top_k,
                                  capacity_factor=cfg.capacity_factor,
                                  compute_dtype=torch.float32,
                                  sharder=sharder)
        res = (_bits(out.full_tensor()),
               {k: float(v.full_tensor()) for k, v in aux.items()})
    return res + tuple(_bits(t) for t in seen["local"]) + (
        list(mesh.get_coordinate()),)



def condition_attention(params) -> None:
    """Every q and k projection rescaled in place to the fan-in of its
    contraction, d_model (``chip_smoke._condition_attention``): the
    reference's init takes the fan-in from the heads, so the attention
    is nearly an argmax and f32 rounding alone moves some configs'
    gradients past 1e-4 of their largest element."""
    import torch
    stack = [params]
    while stack:
        node = stack.pop()
        for name in ("wq", "wk"):
            w = node.get(name)
            if isinstance(w, torch.Tensor):
                w.mul_((w.shape[-2] / w.shape[-3]) ** 0.5)
        stack.extend(v for v in node.values() if isinstance(v, dict))


def sharded_gradients(arch: str, data: int, model: int, kw: dict,
                      condition: bool = False):
    """The loss and gradients of the smoke config ``arch`` (fields ``kw``
    replaced; q and k at fan-in with ``condition``) on one rank and on a
    (data, model) mesh of this world: (loss one rank, loss sharded,
    {leaf: (one rank, sharded)}) from rank 0."""
    import dataclasses
    from repro_torch.configs import arch_rules, get_config
    from repro_torch.data.pipeline import DataState, make_batch
    from repro_torch.launch.mesh import (implicit_replication,
                                         make_local_mesh)
    from repro_torch.models import transformer as T
    from repro_torch.models.common import Sharder, init_params
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import init_state, loss_and_grads, shard_state

    cfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    params = init_params(T.lm_plan(cfg), seed=0, device="cpu")
    if condition:
        condition_attention(params)
    batch = make_batch(cfg, 8, 64, DataState(0, 0), device="cpu")
    loss1, _, g1 = loss_and_grads(params, cfg, batch)
    mesh = make_local_mesh(data, model, device="cpu")
    rules = arch_rules(cfg, "train_4k", model_axis=model, data_axis=data)
    sharded = shard_state(init_state(params, OptConfig()), cfg, rules, mesh)
    sh = Sharder(rules, enabled=True, mesh=mesh)
    with implicit_replication():
        placed = {k: sh.place(v, "batch", None) for k, v in batch.items()}
        loss2, _, g2 = loss_and_grads(sharded["params"], cfg, placed,
                                      sharder=sh)
    one, two = _flat(g1), _flat(g2)
    assert one.keys() == two.keys(), sorted(one.keys() ^ two.keys())
    out = (float(loss1), float(loss2.full_tensor()),
           {k: (one[k], two[k]) for k in one})
    return out if mesh.get_rank() == 0 else None


def _cache_leaves(tree, prefix="") -> dict:
    """``{path: leaf}`` of a cache tree (dicts of `KVCache` or
    `SSMState`)."""
    from repro_torch.models.attention import KVCache
    if isinstance(tree, KVCache):
        tree = {"k": tree.k, "v": tree.v, "kpos": tree.kpos}
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_cache_leaves(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _cache_placements(tree) -> dict:
    """Each DTensor leaf's placements, as a string, by path."""
    return {k: str(v.placements) for k, v in _cache_leaves(tree).items()}


def _cache_flat(tree) -> dict:
    """``{path: (numpy, placements or None)}`` of a cache tree, DTensors
    whole."""
    from repro_torch.launch.mesh import DTensor
    out = {}
    for k, v in _cache_leaves(tree).items():
        placed = str(v.placements) if isinstance(v, DTensor) else None
        whole = v.full_tensor() if isinstance(v, DTensor) else v
        out[k] = (whole.detach().float().numpy().copy(), placed)
    return out


def lm_inputs(cfg, b: int, s: int, seed: int = 1) -> dict:
    """Numpy prompt inputs of ``b`` rows and ``s`` text positions (an
    encoder's frames; a VLM's image embeddings before its tokens)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encoder":
        return {"frames": rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)}
    host = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        host["image_emb"] = rng.standard_normal(
            (b, cfg.prefix_len, cfg.frontend_dim)).astype(np.float32)
    return host


def _lm_case(arch: str, kw: dict, host, b: int, s: int):
    """(config, one-rank parameters on the CPU, torch inputs)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params

    cfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    params = init_params(T.lm_plan(cfg), seed=0, device="cpu")
    if host is None:
        host = lm_inputs(cfg, b, s)
    return cfg, params, {k: torch.from_numpy(v) for k, v in host.items()}


def _place_inputs(sh, inputs: dict) -> dict:
    return {k: sh.place(v, "batch", *(None,) * (v.ndim - 1))
            for k, v in inputs.items()}


def sharded_prefill(arch: str, data: int, model: int, kw: dict,
                    b: int = 4, s: int = 32, host: dict | None = None,
                    cache_len: int | None = None):
    """The prefill of the smoke config ``arch`` (fields ``kw`` replaced)
    on ``b`` prompts of ``s`` tokens (or the numpy inputs ``host``) into
    caches of ``cache_len`` (``s``) positions, on one rank and on a
    (data, model) mesh of this world under the ``prefill_32k`` rules:
    (rules, last logits one rank, sharded, {cache leaf: (one rank,
    sharded, its placements)}) from rank 0.  An encoder has no cache:
    its whole forward's logits stand in for the last ones, as the
    reference's dry run lowers it."""
    import torch
    from repro_torch.configs import arch_rules
    from repro_torch.launch.mesh import (implicit_replication,
                                         make_local_mesh)
    from repro_torch.models import transformer as T
    from repro_torch.models.common import Sharder
    from repro_torch.train.step import shard_params

    cfg, params, inputs = _lm_case(arch, kw, host, b, s)
    cache_len = cache_len or s
    encoder = cfg.family == "encoder"
    with torch.no_grad():
        if encoder:
            last1, caches1 = T.forward(params, cfg, inputs)[0], {}
        else:
            caches1, last1 = T.prefill(params, cfg, inputs, cache_len)
        mesh = make_local_mesh(data, model, device="cpu")
        rules = arch_rules(cfg, "prefill_32k", model_axis=model,
                           data_axis=data)
        sh = Sharder(rules, enabled=True, mesh=mesh)
        with implicit_replication():
            placed = _place_inputs(sh, inputs)
            sharded = shard_params(params, cfg, rules, mesh)
            if encoder:
                last2 = T.forward(sharded, cfg, placed, sharder=sh)[0]
                caches2 = {}
            else:
                caches2, last2 = T.prefill(sharded, cfg, placed, cache_len,
                                           sharder=sh)
            one, two = _cache_flat(caches1), _cache_flat(caches2)
            last2 = last2.full_tensor()
    assert one.keys() == two.keys(), sorted(one.keys() ^ two.keys())
    out = (rules, last1.numpy().copy(), last2.numpy().copy(),
           {k: (one[k][0], two[k][0], two[k][1]) for k in one})
    return out if mesh.get_rank() == 0 else None


def _greedy(params, cfg, caches, last, pos, steps: int, sharder=None,
            tokens=None):
    """``steps`` greedy decode steps from a prefill's caches and last
    logits (or the given ``tokens``, (steps, B)): (tokens fed, logits of
    each step, final caches, each step's cache placements)."""
    import torch
    from repro_torch.launch.mesh import DTensor
    from repro_torch.models import transformer as T

    fed, logits, placed = [], [], []
    tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
    for i in range(steps):
        if tokens is not None:
            tok = torch.from_numpy(tokens[i][:, None])
        fed.append(tok[:, 0].numpy().copy())
        p = torch.tensor(pos + i, dtype=torch.int32)
        t = tok
        if sharder is not None:
            t = sharder.place(tok, "batch", None)
            p = sharder.place(p)
        caches, out = T.decode_step(params, cfg, caches, t, p,
                                    sharder=sharder)
        if isinstance(out, DTensor):
            out = out.full_tensor()
        logits.append(out.numpy().copy())
        if sharder is not None:
            placed.append(_cache_placements(caches))
        tok = torch.argmax(out, dim=-1).to(torch.int32)[:, None]
    return np.stack(fed), np.stack(logits), caches, placed


def sharded_decode(arch: str, shape: str, kw: dict, host: dict,
                   cache_len: int, steps: int):
    """Greedy decode of the smoke config ``arch`` (fields ``kw``
    replaced) from a one-rank prefill of the numpy inputs ``host`` into
    caches of ``cache_len`` positions: ``steps`` steps on one rank, and
    the same tokens on the 2 x 2 (data, model) mesh of this world under
    the rules of the decode shape ``shape``, the prefill's caches placed
    as ``launch.specs.cache_specs`` places that shape's: from rank 0
    (rules, tokens fed (steps, B), logits one rank (steps, B, V),
    sharded, {cache leaf: (one rank, sharded, placements cache_specs
    gives)}, [{cache leaf: placements} after each sharded step])."""
    import torch
    from repro_torch.configs import arch_rules
    from repro_torch.launch.mesh import (distribute_tensor,
                                         implicit_replication,
                                         make_local_mesh)
    from repro_torch.launch.specs import cache_specs
    from repro_torch.models import transformer as T
    from repro_torch.models.common import Sharder
    from repro_torch.train.step import shard_params

    cfg, params, inputs = _lm_case(arch, kw, host, 0, 0)
    pos = host["tokens"].shape[1] + (
        cfg.prefix_len if cfg.family == "vlm" else 0)
    mesh = make_local_mesh(2, 2, device="cpu")
    rules = arch_rules(cfg, shape, model_axis=2, data_axis=2)
    sh = Sharder(rules, enabled=True, mesh=mesh)
    with torch.no_grad():
        caches, last = T.prefill(params, cfg, inputs, cache_len)
        fed, logits1, caches1, _ = _greedy(params, cfg, caches, last, pos,
                                           steps)
        specs = cache_specs(cfg, shape, mesh, rules)
        with implicit_replication():
            placed = T.tree_map(
                lambda t, spec: distribute_tensor(
                    t, mesh, spec.placements, src_data_rank=None),
                caches, specs)
            _, logits2, caches2, after = _greedy(
                shard_params(params, cfg, rules, mesh), cfg, placed, last,
                pos, steps, sharder=sh, tokens=fed)
            one, two = _cache_flat(caches1), _cache_flat(caches2)
    want = _cache_placements(placed)
    out = (rules, fed, logits1, logits2,
           {k: (one[k][0], two[k][0], want[k]) for k in one}, after)
    return out if mesh.get_rank() == 0 else None


def sharded_loss(arch: str, kw: dict, rules: dict, b: int, s: int,
                 smoke: bool = False):
    """The loss of the config ``arch`` (fields ``kw`` replaced; its
    published widths unless ``smoke``) at the seed-0 parameters on the
    batch ``make_batch(cfg, b, s)``: on one rank (rank 0) and on the
    2 x 2 (data, model) mesh of this world under ``rules``: (one rank,
    sharded, one rank in f32 compute) from rank 0."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataState, make_batch
    from repro_torch.launch.mesh import implicit_replication, make_local_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.common import Sharder, init_params
    from repro_torch.train.step import shard_params

    cfg = dataclasses.replace(get_config(arch, smoke=smoke), **kw)
    params = init_params(T.lm_plan(cfg), seed=0, device="cpu")
    batch = make_batch(cfg, b, s, DataState(0, 0), device="cpu")
    mesh = make_local_mesh(2, 2, device="cpu")
    with torch.no_grad():
        one = f32 = None
        if mesh.get_rank() == 0:
            one = float(T.loss_fn(params, cfg, batch)[0])
            f32 = float(T.loss_fn(params, dataclasses.replace(
                cfg, compute_dtype="float32"), batch)[0])
        sh = Sharder(rules, enabled=True, mesh=mesh)
        with implicit_replication():
            placed = {k: sh.place(v, "batch", None) for k, v in batch.items()}
            two = T.loss_fn(shard_params(params, cfg, rules, mesh), cfg,
                            placed, sharder=sh)[0]
            two = float(two.full_tensor())
    return (one, two, f32) if mesh.get_rank() == 0 else None
