"""The port's meshes and collectives (`repro_torch.launch.mesh`).

The pure functions (``engine_mesh_shape``, ``merge_rounds``,
``resolve_merge``) against the reference's over a grid of arguments;
the mesh's layout and its collectives in a gloo world of three CPU
ranks (all_gather in rank order, a partial ppermute with zeros outside
it, the root broadcast bit for bit with ``-0.0`` and a NaN payload, the
integer psum); a world of one in this process (the SPMD mapping's
degenerate case, the one-device answer bit for bit); the type and
membership checks; and the group timeout, which fails a rank whose peer
never arrives instead of hanging it."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from _torch_world import World
from repro.core import parallel as jpar
from repro.launch import mesh as jmesh
from repro_torch.core import parallel as tpar
from repro_torch.launch import mesh as tmesh


@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 6, 8, 12, 16])
def test_engine_mesh_shape_matches_reference(ndev):
    for p in (1, 2, 3, 4, 5, 6, 8, 12, 16, 64, 512):
        assert tmesh.engine_mesh_shape(p, ndev) == \
            jmesh.engine_mesh_shape(p, ndev), (p, ndev)


def test_merge_rounds_and_resolve_merge_match_reference():
    assert [tpar.merge_rounds(w) for w in range(0, 600)] == \
        [jpar.merge_rounds(w) for w in range(0, 600)]
    grid = itertools.product(("flat", "tree", "auto"), (None, 1, 2, 3, 8),
                             (None, 8, 64), (16, 64, 4096), (2, 4, 9),
                             (64, 1024, 16384))
    for merge, w, p, local_cap, d, cap in grid:
        kw = dict(axis_size=w, p_total=p, local_cap=local_cap, d=d)
        got = tpar.resolve_merge(tpar.SkyConfig(merge=merge, capacity=cap),
                                 **kw)
        want = jpar.resolve_merge(jpar.SkyConfig(merge=merge, capacity=cap),
                                  **kw)
        assert got == want, (merge, kw, cap)
    with pytest.raises(ValueError, match="bogus"):
        tpar.resolve_merge(tpar.SkyConfig(merge="bogus"))


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    w = World(3, tmp_path_factory.mktemp("w3"))
    yield w
    w.close()


@pytest.mark.parametrize("workers", [1, 2, 3])
def test_collectives_in_a_world_of_three(world3, workers):
    out = world3.run("collectives", workers)
    for r in range(workers, 3):
        assert out[r] is None                     # outside the prefix mesh
    nan_bits = np.int32(0x7FC01234)
    root = np.array([-0.0, 1.5], np.float32).view(np.int32).tolist()
    for r in range(workers):
        o = out[r]
        assert o["index"] == (r, 0, workers, 1)
        want = np.array([[float(w), -0.0] for w in range(workers)],
                        np.float32)
        np.testing.assert_array_equal(o["gather"].view(np.int32),
                                      want.view(np.int32))
        np.testing.assert_array_equal(
            o["gather1"], [[x for w in range(workers) for x in (w == 1, True)]])
        # pairs (1, 0), (3, 2), ...: even workers with a right neighbour
        # receive it, every other worker gets zeros
        if r % 2 == 0 and r + 1 < workers:
            want = np.array([r + 1.5, -0.0], np.float32)
        else:
            want = np.zeros(2, np.float32)
        np.testing.assert_array_equal(o["ppermute"].view(np.int32),
                                      want.view(np.int32))
        assert o["bcast"].tolist() == root + [nan_bits]
        np.testing.assert_array_equal(
            o["psum"], [workers * (workers - 1) // 2, workers])


def test_world_of_one_in_process_is_the_one_device_answer():
    """A mesh of this process alone (a world of one joined on first use)
    runs every path; the answer is the one-device answer bit for bit."""
    mesh = tmesh.make_worker_mesh(device="cpu")
    assert (mesh.queries, mesh.workers, mesh.member) == (1, 1, True)
    assert tmesh.make_engine_mesh(device="cpu") is mesh     # cached
    assert mesh.backend == "gloo" and not mesh.staged
    rng = np.random.default_rng(3)
    x = (np.round(rng.random((240, 3)) * 8) / 8).astype(np.float32)
    for kw in (dict(), dict(merge="tree"), dict(noseq=True, merge="tree"),
               dict(rep_filter="sorted", merge="tree")):
        cfg = tpar.SkyConfig(p=4, capacity=256, block=64, bucket_factor=4.0,
                             **kw)
        want, _ = tpar.parallel_skyline(x, cfg=cfg, device="cpu")
        got, _ = tpar.parallel_skyline(x, cfg=cfg, mesh=mesh)
        for g, w in zip(got, want):
            assert g.device.type == "cpu"
            assert torch.equal(g.view(torch.int32) if g.is_floating_point()
                               else g, w.view(torch.int32)
                               if w.is_floating_point() else w), kw


def test_mesh_argument_checks():
    x = np.zeros((16, 2), np.float32)
    with pytest.raises(TypeError, match="WorkerMesh"):
        tpar.parallel_skyline(x, mesh=object(), device="cpu")
    mesh = tmesh.make_worker_mesh(device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tpar.shard_of(dataclasses.replace(mesh, workers=3, w_index=0), 1, 8,
                      False)
    with pytest.raises(ValueError, match="outside"):
        dataclasses.replace(mesh, w_index=None).check_member()
    with pytest.raises(ValueError, match="needs 2 devices"):
        tmesh.make_engine_mesh(2, 1, device="cpu")
    with pytest.raises(TypeError, match="integers"):
        mesh.psum(torch.zeros(2))


def test_a_rank_that_never_arrives_fails_by_timeout(tmp_path):
    """Every group carries a timeout: rank 0's all_gather, which rank 1
    never joins, raises after about three seconds; the run returns."""
    world = World(2, tmp_path)
    try:
        out = world.run("hang", 2, deadline=60)
    finally:
        world.close()
    status, err, secs = out[0]
    assert status == "raised", out[0]
    assert 2.0 < secs < 30.0
    assert out[1][0] == "idle"
