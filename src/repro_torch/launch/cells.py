"""The skyline program suite of the port, run by the program verifier.

Counterpart of ``repro.launch.cells``: the same cells, by name and
geometry.  The reference builds each cell as a jitted program and its
argument specs; the port has no tracer, so a `BuiltCell` holds the
program as a callable and real input tensors, made with numpy from a
fixed seed and moved to the device once.  The inputs are already
packed, as the reference's argument specs are, so each program is what
runs after the engine's level-1 pack:

  ``fused``, ``batch``, ``vmap_batch``  ``fused_skyline_batch_fn(cfg)``
                    on (Q, N, d) points (Q = 1 for ``fused``);
  ``sweep``         the fused SFS sweep (`repro_torch.kernels.sfs`) on a
                    presorted, sentinel-filled (P, npad, d) batch;
  ``stream``        the batched insert (``incremental._insert_batch``)
                    into Q live states;
  ``window``        the windowed insert (``windowed.insert_chunk``) into
                    Q live epoch rings;
  ``wtick``         the fused serving tick (``windowed.window_tick``,
                    rotate on a 0-d device flag, insert, merge on read);
  ``slab_feed``     one slab wave (``serve.engine._slab_feed``) on a
                    `SlabArena`: gather, insert, write back in place;
  ``slab_wave``     the same with the previous wave's inserted states
                    chained in as a pending record.

The stateful cells start from a live state: the build runs one warm-up
call (the first chunk) and the cell's program takes the second.  The
mesh axes are the reference's, scaled to the ranks of the world as the
reference scales them to its devices (`_scaled_axes`): ``fused`` cells
run on a 1-D workers mesh, ``batch``, ``stream``, ``window`` and the
slab cells on a 2-D (queries x workers) mesh, ``wtick`` on a 1-D mesh,
and ``sweep`` and ``vmap_batch`` on no mesh.  A mesh takes a prefix of
the ranks; on a rank outside it the cell is not built (``fn`` is None).
In a world of one no cell has a mesh, so the programs are the
one-device callers' (``mesh=None``), unless the build asks for 1 x 1
meshes (``meshed=True``).
Every cell runs the sliced strategy, so no program holds a generator.
This module does no device work at import.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

__all__ = ["SKYLINE_CELLS", "VERIFIER_EXTRA_CELLS", "BuiltCell",
           "build_skyline_cell"]


# the reference's dry-run cells (repro/launch/cells.py), names and
# geometries unchanged; `smoke` shrinks n by 64 and capacity by 16
SKYLINE_CELLS = {
    "fused_p512": dict(kind="fused", n=1_000_000, d=4, p=512, workers=512,
                       capacity=16384, block=512),
    "tree_merge_p512": dict(kind="fused", n=1_000_000, d=4, p=512,
                            workers=512, capacity=16384, block=512,
                            merge="tree"),
    "batch_8x64": dict(kind="batch", q=8, n=262_144, d=4, p=64, queries=8,
                       workers=64, capacity=8192, block=512),
    "stream_8x64": dict(kind="stream", q=8, n=65_536, d=4, p=64,
                        queries=8, workers=64, capacity=8192, block=512),
    "sweep_p64": dict(kind="sweep", n=16_384, d=4, p=64, capacity=4096,
                      block=512),
    "window_8x64": dict(kind="window", q=8, n=65_536, d=4, p=64,
                        epochs=8, queries=8, workers=64, capacity=8192,
                        block=512),
}

# the reference's verifier-only cells, at their declared sizes
VERIFIER_EXTRA_CELLS = {
    # the engine's bucket program below the shard threshold: must be
    # collective-free
    "engine_vmap": dict(kind="vmap_batch", q=4, n=2048, d=4, p=4,
                        capacity=1024, block=64),
    # the fused serving tick (rotate ring + head insert + merged front)
    "window_tick": dict(kind="wtick", n=1024, d=4, p=4, epochs=4,
                        workers=4, capacity=512, block=64),
    # one slab wave with a per-epoch capacity BELOW the state capacity:
    # full C never crosses the arena's gather or scatter
    "slab_feed": dict(kind="slab_feed", q=4, slots=6, n=256, d=4, p=4,
                      epochs=4, rows=64, queries=2, workers=2,
                      capacity=512, block=64, epoch_capacity=100),
    # the serve loop's coalesced wave with the previous wave's pending
    # record chained in
    "slab_wave": dict(kind="slab_wave", q=6, slots=8, n=256, d=4, p=4,
                      epochs=4, rows=64, queries=2, workers=2,
                      capacity=512, block=64, epoch_capacity=100),
    # the window-tiled sweep at capacity 16384, block 512
    "sweep_tiled": dict(kind="sweep", n=16_384, d=4, p=4,
                        capacity=16_384, block=512, wtile=512),
}

_SEED = 19


class BuiltCell(NamedTuple):
    """One constructed skyline program with its inputs on the device.

    ``fn(*args)`` runs the program once (``fn`` is None on a rank
    outside the cell's ``mesh``).  ``state`` holds the leaves the
    program writes in place (the state operand's, or the slab arena's)
    and ``updated(outputs)`` the leaves that hold the state after a
    call (empty and None for stateless kinds).  ``host`` keeps the numpy
    arrays the inputs were made from (``"warm"``: the warm-up chunk,
    ``"chunk"``: the program's), so that another implementation can be
    run on the same data."""
    name: str
    kind: str
    fn: Callable
    args: tuple
    cfg: Any          # repro_torch.core.parallel.SkyConfig
    mesh: Any         # repro_torch.launch.mesh.WorkerMesh | None
    info: dict
    state: tuple
    updated: Callable | None
    host: dict


def _config(spec: dict, smoke: bool):
    """The cell's `SkyConfig`: the reference's (sliced strategy, bucket
    factor 1.5, the spec's capacity, block, tile and merge), donating
    unless the spec says ``donate=False``."""
    from repro_torch.core.parallel import SkyConfig
    return SkyConfig(strategy="sliced", p=spec["p"],
                     capacity=max(spec["capacity"] // (16 if smoke else 1),
                                  spec["block"]),
                     block=spec["block"], wtile=spec.get("wtile", 0),
                     bucket_factor=1.5, merge=spec.get("merge", "flat"),
                     donate=spec.get("donate", True))


def _pow2_floor(x: int) -> int:
    b = 1
    while b * 2 <= x:
        b *= 2
    return b


def _scaled_axes(spec: dict, ranks: int):
    """Mesh sizes ``(queries, workers)`` for a world of ``ranks``: the
    workers axis is the largest power of two that fits the ranks and
    divides p, leaving room for two query shards where the world allows
    (the reference's scaling to its live devices)."""
    want_q = spec.get("queries")
    want_w = spec.get("workers", 1)
    ndev = max(int(ranks), 1)
    p = spec["p"]
    if want_q is None:
        w = 1
        while w * 2 <= min(want_w, ndev) and p % (w * 2) == 0:
            w *= 2
        return None, w
    w_lim = max(1, ndev // 2) if ndev >= 4 else ndev
    w = 1
    while w * 2 <= min(want_w, w_lim) and p % (w * 2) == 0:
        w *= 2
    q = max(1, min(want_q, _pow2_floor(ndev // w)))
    return q, w


def _mesh(kind: str, spec: dict, ranks: int, dev, meshed: bool):
    """The cell's mesh on a world of ``ranks`` (None: no mesh; in a
    world of one, unless ``meshed``)."""
    from repro_torch.launch.mesh import make_engine_mesh, make_worker_mesh
    if kind in ("sweep", "vmap_batch") or (ranks == 1 and not meshed):
        return None
    if kind in ("fused", "wtick"):
        _, nw = _scaled_axes(dict(spec, queries=None), ranks)
        return make_worker_mesh(nw, device=dev)
    nq, nw = _scaled_axes(spec, ranks)
    return make_engine_mesh(nq, nw, device=dev)


def _chunk(rng, lead: tuple, n: int, d: int):
    """Uniform points in [0, 1) with about one row in ten masked out."""
    pts = rng.random(lead + (n, d), dtype=np.float32)
    mask = rng.random(lead + (n,)) >= 0.1
    return pts, mask


def build_skyline_cell(name: str, spec: dict, *, smoke: bool = False,
                       device=None, ranks: int | None = None,
                       meshed: bool = False) -> BuiltCell:
    """Construct one cell's program and its inputs on ``device`` (the
    card unless ``"cpu"`` is given; without CUDA that raises).

    ``smoke`` shrinks the dry-run cells' data sizes (n by 64, capacity by
    16, as the reference does).  The data are made from a fixed seed, so
    two builds of one spec get the same inputs.  The mesh axes scale to
    ``ranks`` (default: the world's; one outside a world); at one rank
    the cells have no mesh unless ``meshed`` asks for 1 x 1 meshes.
    Every rank of the world builds every cell (the meshes are made by
    all ranks together)."""
    from repro_torch.core import incremental, windowed
    from repro_torch.core import parallel as par
    from repro_torch.core.dominance import SENTINEL
    from repro_torch.core.sfs import sweep_inputs
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.kernels.sfs import sfs_sweep
    from repro_torch.launch.mesh import world_size

    dev = resolve_device(device)
    kind = spec["kind"]
    mesh = _mesh(kind, spec, world_size() if ranks is None else ranks, dev,
                 meshed)
    if mesh is not None:
        dev = mesh.device
    n = spec["n"] // (64 if smoke else 1)
    d = spec["d"]
    cfg = _config(spec, smoke)
    rng = np.random.default_rng(_SEED)
    info = {"n": n, "d": d, "p": cfg.p, "capacity": cfg.capacity,
            "block": cfg.block, "wcap": -(-cfg.capacity // cfg.block)
            * cfg.block,
            "mesh": None if mesh is None else dict(mesh.shape)}
    for key in ("q", "epochs", "workers", "queries"):
        if key in spec:
            info[key] = spec[key]
    q = spec.get("q", 1)
    state: tuple = ()
    updated = None
    host: dict = {}
    if mesh is not None and not mesh.member:
        return BuiltCell(name, kind, None, (), cfg, mesh, info, state, None,
                         host)

    if kind in ("fused", "batch", "vmap_batch"):
        pts, mask = _chunk(rng, (q,), n, d)
        host["chunk"] = (pts, mask)
        fn = par.fused_skyline_batch_fn(cfg, mesh)
        args = (torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev))
    elif kind == "sweep":
        p = spec["p"]
        pts, mask = _chunk(rng, (p,), n // p, d)
        host["chunk"] = (pts, mask)
        pts_p, mask_p, block, wcap = sweep_inputs(
            torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev),
            capacity=cfg.capacity, block=cfg.block)
        info["wcap"] = wcap
        fn = functools.partial(sfs_sweep, block=block, wcap=wcap,
                               sentinel=SENTINEL, wtile=cfg.wtile,
                               spec=cfg.impl)
        args = (pts_p, mask_p)
    elif kind == "stream":
        warm = _chunk(rng, (q,), n, d)
        pts, mask = _chunk(rng, (q,), n, d)
        host.update(warm=warm, chunk=(pts, mask))
        st = incremental.init_state(cfg, d, q=q, device=dev)
        st, _ = incremental._insert_batch(
            st, torch.from_numpy(warm[0]).to(dev),
            torch.from_numpy(warm[1]).to(dev), cfg=cfg, donate=True,
            mesh=mesh)

        def fn(st, pts, mask):
            return incremental._insert_batch(st, pts, mask, cfg=cfg,
                                             donate=cfg.donate, mesh=mesh)

        args = (st, torch.from_numpy(pts).to(dev),
                torch.from_numpy(mask).to(dev))
        state = tuple(st)
        updated = _first_tree
    elif kind in ("window", "wtick"):
        e = spec["epochs"]
        lead = (q,) if kind == "window" else ()
        warm = _chunk(rng, lead, n, d)
        pts, mask = _chunk(rng, lead, n, d)
        host.update(warm=warm, chunk=(pts, mask))
        st = windowed.init_window_state(
            cfg, d, epochs=e, q=q if kind == "window" else None, device=dev)
        st, _ = windowed.insert_chunk(
            st, torch.from_numpy(warm[0]).to(dev),
            torch.from_numpy(warm[1]).to(dev), cfg=cfg, mesh=mesh)
        st, _ = windowed.advance_epoch(st, donate=cfg.donate)
        args = (st, torch.from_numpy(pts).to(dev),
                torch.from_numpy(mask).to(dev))
        if kind == "window":
            def fn(st, pts, mask):
                return windowed.insert_chunk(st, pts, mask, cfg=cfg,
                                             mesh=mesh)
        else:
            def fn(st, pts, mask, advance):
                return windowed.window_tick(st, pts, mask, cfg=cfg,
                                            advance=advance, mesh=mesh)

            args += (torch.ones((), dtype=torch.bool, device=dev),)
        state = tuple(st)
        updated = _first_tree
    elif kind in ("slab_feed", "slab_wave"):
        fn, args, state, updated = _slab_cell(spec, cfg, q, n, d, rng, dev,
                                              host, info, kind, mesh)
    else:
        raise ValueError(f"unknown skyline cell kind {kind!r}")
    return BuiltCell(name, kind, fn, args, cfg, mesh, info, state, updated,
                     host)


def _first_tree(out) -> tuple:
    """The state leaves of a ``(state, ...)`` result."""
    return tuple(out[0])


def _slab_cell(spec, cfg, q, n, d, rng, dev, host, info, kind, mesh):
    """A slab arena of ``max(slots, q)`` slots, one warm-up wave into the
    first q, and the cell's wave (chaining the warm-up's inserted states
    as a pending record for ``slab_wave``)."""
    from repro_torch.core.windowed import epoch_rows
    from repro_torch.serve.engine import _slab_feed
    from repro_torch.serve.slab import SlabArena

    e, rows = spec["epochs"], spec["rows"]
    slots = max(spec["slots"], q)
    cap = epoch_rows(cfg, spec["epoch_capacity"])
    info.update(rows=rows, epoch_cap=cap, slots=slots)
    arena = SlabArena(epochs=e, rows=rows, d=d, init_slots=slots,
                      device=dev)
    heads_np = rng.integers(0, e, size=q)
    warm = _chunk(rng, (q,), n, d)
    pts, mask = _chunk(rng, (q,), n, d)
    host.update(warm=warm, chunk=(pts, mask), heads=heads_np,
                slots=slots, cap=cap)
    idx = torch.arange(q, device=dev)
    heads = torch.from_numpy(heads_np).to(dev)
    sub, _, _ = _slab_feed(cfg, arena, rows, q, cap, idx, heads,
                           torch.from_numpy(warm[0]).to(dev),
                           torch.from_numpy(warm[1]).to(dev), None, [], mesh)
    pend = []
    if kind == "slab_wave":
        pend = [(tuple(sub), idx, torch.ones((q,), dtype=torch.bool,
                                            device=dev), heads)]

    def fn(idx, heads, pts, mask, pend):
        return _slab_feed(cfg, arena, rows, q, cap, idx, heads, pts, mask,
                          None, pend, mesh)

    def updated(out):
        del out
        return tuple(arena.leaves())

    args = (idx, heads, torch.from_numpy(pts).to(dev),
            torch.from_numpy(mask).to(dev), pend)
    return fn, args, tuple(arena.leaves()), updated
