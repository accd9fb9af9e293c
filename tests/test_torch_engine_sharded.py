"""The engine's 2-D (queries x workers) dispatch on gloo CPU ranks.

Counterpart of ``tests/test_engine_sharded.py``.  In one world of eight
ranks (`_torch_world.World`): on 2 x 2 and 2 x 4 meshes, with Q = 4 and
8 ragged queries (masked ones among them), the sharded engine's answers
and stream snapshots are the one-device engine's bit for bit, on every
rank, and for four of the cases the reference's sharded engine's on
the same mesh (JAX subprocesses with eight forced host devices; the
random strategy is held against the one-device engine only, since torch
cannot draw the reference's threefry ids per request); buckets below ``shard_threshold_n`` run on one device and those
at or above it sharded; ``calibrate_shard_threshold`` times the
one-device batch, every factoring and both merges and routes each
bucket through its winner; and the scheduler's default engine takes a
mesh over the world.  In this process: the mesh checks of the
constructor and the calibration's grid rule."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from _torch_world import World
from repro_torch.core.parallel import SkyConfig
from repro_torch.launch.mesh import make_engine_mesh
from repro_torch.serve.engine import SkylineEngine, calibrate_shard_threshold

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORLD = 8


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(WORLD, tmp_path_factory.mktemp("world"))
    yield w
    w.close()


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _queries(q, seed):
    rng = np.random.default_rng(seed)
    sizes = [300, 700, 520, 128, 640, 333, 480, 600][:q]
    out = []
    for i, n in enumerate(sizes):
        x = rng.random((n, 4), dtype=np.float32)
        if i % 2:   # anticorrelated on a lattice: ties and duplicates
            x[:, 1] = 1 - x[:, 0]
            x = np.round(x * 16) / 16
        out.append(x.astype(np.float32))
    masks = [None if i % 3 else rng.random(len(x)) > 0.2
             for i, x in enumerate(out)]
    return out, masks


CFGS = {
    "sliced": dict(strategy="sliced", p=8, capacity=1024, block=64,
                   bucket_factor=4.0),
    "grid-rep-noseq-tree": dict(strategy="grid", p=16, m=2, capacity=1024,
                                block=64, bucket_factor=8.0,
                                rep_filter="sorted", noseq=True,
                                merge="tree"),
    "random-tree": dict(strategy="random", p=8, capacity=1024, block=64,
                        bucket_factor=4.0, merge="tree"),
}


SHAPES = [((2, 2), 4), ((2, 4), 8), ((2, 4), 4), ((2, 2), 8)]
# each (mesh, Q) once against the reference engine, each configuration
# that torch draws alike on a 2 x 2 and a 2 x 4 mesh (about 15 s of JAX
# compiles a case); the random strategy's ids are threefry draws per
# request, so it is held against the one-device engine only
REFERENCE_CASES = [("sliced", SHAPES[0]), ("sliced", SHAPES[1]),
                   ("grid-rep-noseq-tree", SHAPES[2]),
                   ("grid-rep-noseq-tree", SHAPES[3])]

_REFERENCE = """
import json, sys
import numpy as np, jax.numpy as jnp
from repro.core import SkyConfig
from repro.launch.mesh import make_engine_mesh
from repro.serve.api import SkylineRequest, StreamOptions
from repro.serve.engine import SkylineEngine

spec = json.load(open(sys.argv[1]))
data = np.load(sys.argv[2])
out = {}
for name, qa, wa, q, cfg in spec:
    items = [data[f"{name}/x{i}"] for i in range(q)]
    masks = [data[f"{name}/m{i}"] if f"{name}/m{i}" in data else None
             for i in range(q)]
    eng = SkylineEngine(SkyConfig(**cfg), min_n_bucket=64,
                        mesh=make_engine_mesh(qa, wa), shard_threshold_n=64)
    reqs = [SkylineRequest(data=jnp.asarray(x),
                           mask=None if m is None else jnp.asarray(m))
            for x, m in zip(items, masks)]
    for i, (b, _) in enumerate(eng.submit_many(reqs)):
        for k, leaf in enumerate(b):
            out[f"{name}/got/{i}/{k}"] = np.asarray(leaf)
    assert eng.sharded_dispatched == eng.batches_dispatched >= 3
    st = eng.open_stream(items[0].shape[1], StreamOptions(q=q))
    for lo in (0, 64):
        st.feed([jnp.asarray(x[lo:lo + 64]) for x in items])
    for i, b in enumerate(st.drain().snapshot()):
        for k, leaf in enumerate(b):
            out[f"{name}/stream/{i}/{k}"] = np.asarray(leaf)
    st.close()
np.savez(sys.argv[3], **out)
print("OK")
"""


def _case_name(cfg, shape, q):
    return f"{cfg}-{shape[0]}x{shape[1]}-q{q}"


@pytest.fixture(scope="module")
def reference(world, tmp_path_factory):
    """The reference engine's answers on the same meshes for
    `REFERENCE_CASES`; one JAX subprocess per case, all at once, the
    world's ranks starting meanwhile."""
    tmp = tmp_path_factory.mktemp("ref")
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={WORLD}"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    parts = [(cfg, [sq]) for cfg, sq in REFERENCE_CASES]
    procs = []
    for j, (cfg, shapes) in enumerate(parts):
        spec, arrays = [], {}
        for shape, q in shapes:
            name = _case_name(cfg, shape, q)
            items, masks = _queries(q, seed=q + shape[1])
            for i, (x, m) in enumerate(zip(items, masks)):
                arrays[f"{name}/x{i}"] = x
                if m is not None:
                    arrays[f"{name}/m{i}"] = m
            spec.append([name, shape[0], shape[1], q, CFGS[cfg]])
        (tmp / f"spec{j}.json").write_text(json.dumps(spec))
        np.savez(tmp / f"in{j}.npz", **arrays)
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             textwrap.dedent(_REFERENCE),
             str(tmp / f"spec{j}.json"), str(tmp / f"in{j}.npz"),
             str(tmp / f"out{j}.npz")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env))
    out = {}
    for j, proc in enumerate(procs):
        try:
            stdout, stderr = proc.communicate(timeout=300)
        finally:
            proc.kill()
        assert proc.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
        out.update(np.load(tmp / f"out{j}.npz"))
    return out


@pytest.mark.parametrize("shape,q", SHAPES)
@pytest.mark.parametrize("cfg", list(CFGS))
def test_sharded_engine_matches_one_device_engine(world, reference, shape,
                                                  q, cfg):
    items, masks = _queries(q, seed=q + shape[1])
    out = world.run("engine_case", shape[0], shape[1], items, CFGS[cfg], 64,
                    masks)
    n = shape[0] * shape[1]
    assert all(o is None for o in out[n:])
    name = _case_name(cfg, shape, q)
    held = (cfg, (shape, q)) in REFERENCE_CASES
    for r, o in enumerate(out[:n]):
        if held:    # the reference's sharded engine, leaf by leaf
            for i, (g, _) in enumerate(o["got"]):
                for k, a in enumerate(g):
                    np.testing.assert_array_equal(
                        _bits(a), _bits(reference[f"{name}/got/{i}/{k}"]),
                        err_msg=f"rank {r} query {i} leaf {k}")
            for i, b in enumerate(o["streams"][0]):
                for k, a in enumerate(b):
                    np.testing.assert_array_equal(
                        _bits(a), _bits(reference[f"{name}/stream/{i}/{k}"]),
                        err_msg=f"rank {r} stream {i} leaf {k}")
        assert o["sharded"] == o["batches"] >= 3   # every bucket sharded
        for (g, gv), (w, wv) in zip(o["got"], o["want"]):
            for k, (a, b) in enumerate(zip(g, w)):
                np.testing.assert_array_equal(_bits(a), _bits(b),
                                              err_msg=f"rank {r} leaf {k}")
            assert gv == wv
        for a, b in zip(*o["streams"]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(_bits(x), _bits(y))
        # every rank holds the same answers
        for (g, _), (h, _) in zip(o["got"], out[0]["got"]):
            for a, b in zip(g, h):
                np.testing.assert_array_equal(_bits(a), _bits(b))


def test_threshold_routes_small_buckets_to_one_device(world):
    rng = np.random.default_rng(0)
    small = [rng.random((100, 4), dtype=np.float32) for _ in range(3)]
    large = [rng.random((1500, 4), dtype=np.float32) for _ in range(3)]
    out = world.run("routing_case", 2, 4, small, large, 1024)
    for o in out:
        assert o["small"] == 0, "below the threshold must not shard"
        assert o["large"] == 1, "at or above it must shard"
        assert o["mixed"] == (6, 1, 2)


def test_calibrated_factorings_route_each_bucket(world):
    cfg = dict(strategy="sliced", p=8, capacity=512, block=64,
               bucket_factor=1.5)
    out = world.run("calibrate_case", 2, 4, cfg, [256])
    for rep, fact, routed in out:
        (nb, t), = rep["measurements"].items()
        assert set(t["factorings"]) == {"8x1", "4x2", "2x4", "1x8"}
        assert set(t["merge"]) == {"flat", "tree"}
        assert t["best_merge"] in ("flat", "tree")
        assert fact[nb] == (*(int(x) for x in t["best_factoring"]
                              .split("x")), t["best_merge"])
        assert routed[nb] == fact[nb][:2]
        assert rep["factorings"][nb] == \
            f"{t['best_factoring']}:{t['best_merge']}"
        assert {"applied", "threshold_n", "measurements",
                "factorings"} <= set(rep)
    # every rank took the same decisions
    assert all(o[1] == out[0][1] for o in out)
    assert all(o[0]["threshold_n"] == out[0][0]["threshold_n"] for o in out)


def test_default_engine_takes_a_mesh_over_the_world(world):
    assert world.run("default_engine_case") == [(2, 4)] * WORLD


def test_engine_rejects_a_mesh_without_engine_axes_or_of_another_type():
    mesh = make_engine_mesh(device="cpu")       # a world of one
    with pytest.raises(ValueError, match="queries|workers"):
        SkylineEngine(SkyConfig(), mesh=mesh, q_axis="data")
    with pytest.raises(TypeError, match="WorkerMesh"):
        SkylineEngine(SkyConfig(), mesh=object(), device="cpu")


def test_calibration_skips_factorings_for_d_dependent_strategies():
    """grid and angular derive p from d, so no factoring is stored; the
    threshold is still calibrated (on a 1 x 1 mesh in this process)."""
    cfg = SkyConfig(strategy="grid", p=16, capacity=256, block=64,
                    bucket_factor=8.0)
    engine = SkylineEngine(cfg, mesh=make_engine_mesh(1, 1, device="cpu"),
                           min_n_bucket=64)
    rep = calibrate_shard_threshold(engine, bucket_sizes=(64,), repeat=1)
    assert rep["factorings"] == {} and engine.factorings == {}
    assert "threshold_n" in rep and rep["measurements"]
    assert engine.wave_time_hints
