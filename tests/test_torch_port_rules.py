"""Rules the port keeps: it imports no JAX, its entry points run on the
card unless asked for the CPU, its kernels run on CUDA tensors only and
check their arguments, unported options raise, and state crosses between
the packages with every bit kept (tolerance: zero)."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import parallel as jpar
from repro_torch import convert
from repro_torch.core import api, incremental, parallel, sfs
from repro_torch.kernels import backend
from repro_torch.kernels.dominance import kernel as dkernel
from repro_torch.kernels.dominance import ops as dops
from repro_torch.kernels.sfs import kernel, ops

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_no_jax_and_nothing_of_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


@pytest.mark.parametrize("entry", ["parallel_skyline", "skyline",
                                   "skyline_mask_exact", "skyline_mask"])
def test_entry_points_raise_without_cuda(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).random((50, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(api, entry)(x)
    getattr(api, entry)(x, device="cpu")   # the CPU only when asked


@pytest.mark.parametrize("q", [None, 2])
def test_streaming_entry_points_raise_without_cuda(q, monkeypatch):
    """``init_state`` makes its state on the card unless asked for the
    CPU; ``insert_chunk`` and ``finalize`` run where the state lies and
    move the chunk there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = parallel.SkyConfig(capacity=64, block=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.init_state(cfg, 3, q=q)
    state = api.init_state(cfg, 3, q=q, device="cpu")
    lead = () if q is None else (q,)
    x = np.random.default_rng(0).random(lead + (40, 3)).astype(np.float32)
    state, stats = api.insert_chunk(state, x, cfg=cfg)
    assert all(leaf.device.type == "cpu" for leaf in state)
    assert state.points.shape == lead + (64, 3)
    assert state.seen.tolist() == ([40] * q if q else 40)
    buf = api.finalize(state, cfg=cfg)
    assert buf.points.device.type == "cpu"
    with pytest.raises(ValueError, match="does not fit the state"):
        api.insert_chunk(state, x[..., :2], cfg=cfg)


def test_auto_follows_the_data():
    assert backend.resolve_spec("auto", torch.device("cpu")).sweep == "torch"
    assert backend.resolve_spec("auto", torch.device("cuda")).sweep == "cuda"
    for impl in ("torch", "perpair"):
        assert backend.resolve_spec(impl, torch.device("cuda")).sweep == impl
    with pytest.raises(ValueError, match="unknown kernel backend"):
        backend.resolve_spec("jnp", torch.device("cpu"))


def test_dominance_family_in_the_registry():
    """'cuda' -> 'cuda', 'torch' -> 'torch', 'perpair' -> 'torch' (the
    reference maps it to 'jnp'); max_d is the minimum over both
    families."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert backend.resolve_spec("auto", cuda).dominance == "cuda"
    assert backend.resolve_spec("auto", cpu).dominance == "torch"
    assert backend.resolve_spec("torch", cuda).dominance == "torch"
    assert backend.resolve_spec("perpair", cpu).dominance == "torch"
    assert backend.resolve_spec("cuda", cuda).max_d == min(
        kernel.D_MAX, dkernel.D_MAX)
    assert backend.resolve_spec("torch", cpu).max_d is None
    with pytest.raises(ValueError, match="unknown dominance impl"):
        backend.KernelSpec("x", sweep="torch", dominance="jnp")


def test_cuda_impl_on_cpu_tensor_raises():
    x = torch.rand(2, 64, 3)
    m = torch.ones(2, 64, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.sfs_sweep(x, m, block=32, wcap=64, sentinel=1.7e38, spec="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        sfs.local_skyline_batch(x, capacity=64, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        api.parallel_skyline(x[0], cfg=parallel.SkyConfig(impl="cuda"),
                             device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.sfs_sweep_cuda(x, m, block=32, wcap=64, sentinel=1.7e38)


def test_cuda_dominance_on_cpu_tensor_raises():
    x = torch.rand(2, 64, 3)
    m = torch.ones(2, 64, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        dops.dominated_mask(x, x, m, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        sfs.skyline_mask(x[0], impl="cuda", device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        api.parallel_skyline(x[0], cfg=parallel.SkyConfig(
            impl="cuda", noseq=True), device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        dkernel.dominated_mask_cuda(x, x, m)
    with pytest.raises(ValueError, match="unknown dominance impl"):
        dops.dominated_mask(x, x, m, impl="jnp")


@pytest.mark.parametrize("bad", [
    dict(cands=torch.rand(2, 64, 3, dtype=torch.float64)),        # dtype
    dict(refs=torch.rand(2, 40, 3).to(torch.bfloat16)),
    dict(mask=torch.ones(2, 40, dtype=torch.uint8)),              # mask dtype
    dict(cands=torch.rand(2, 3, 64).transpose(1, 2)),             # layout
    dict(refs=torch.rand(2, 3, 40).transpose(1, 2)),
    dict(mask=torch.ones(2, 80, dtype=torch.bool)[:, ::2]),
    dict(mask=torch.ones(2, 39, dtype=torch.bool)),               # shape
    dict(refs=torch.rand(3, 40, 3)),
    dict(cands=torch.rand(64, 3)),                                # rank
    dict(cands=torch.rand(2, 64, 13), refs=torch.rand(2, 40, 13)),  # d > 12
    dict(cands=torch.rand(0, 64, 3), refs=torch.rand(0, 40, 3),
         mask=torch.ones(0, 40, dtype=torch.bool)),               # B = 0
])
def test_dominance_kernel_argument_checks(bad):
    args = dict(cands=torch.rand(2, 64, 3), refs=torch.rand(2, 40, 3),
                mask=torch.ones(2, 40, dtype=torch.bool))
    dkernel.check_args(args["cands"], args["refs"], args["mask"])
    # references and mask broadcast over the batch are taken
    dkernel.check_args(args["cands"], args["refs"][:1].expand(2, 40, 3),
                       args["mask"][:1].expand(2, 40))
    args.update(bad)
    with pytest.raises(ValueError):
        dkernel.check_args(args["cands"], args["refs"], args["mask"])


def test_dominance_entry_argument_checks():
    x = torch.rand(2, 64, 3)
    with pytest.raises(ValueError, match="expected cands"):
        dops.dominated_mask(x[0, 0], x[0])
    with pytest.raises(ValueError, match="d=3, refs d=2"):
        dops.dominated_mask(x, x[..., :2])
    with pytest.raises(ValueError, match="does not fit"):
        dops.dominated_mask(x, x, torch.ones(63, dtype=torch.bool))
    with pytest.raises(ValueError, match="expected cands"):
        dops.dominated_mask(x[0], x)
    with pytest.raises(ValueError, match="needs batched cands"):
        dops.dominated_mask(x[0], x[0], torch.ones(2, 64, dtype=torch.bool))
    with pytest.raises(ValueError, match="float64"):
        dops.dominated_mask(x, x.double())


@pytest.mark.parametrize("bad", [
    dict(pts=torch.rand(2, 64, 3, dtype=torch.float64)),          # dtype
    dict(mask=torch.ones(2, 64, dtype=torch.uint8)),              # mask dtype
    dict(pts=torch.rand(2, 3, 64).transpose(1, 2)),               # layout
    dict(mask=torch.ones(2, 63, dtype=torch.bool)),               # shape
    dict(pts=torch.rand(2, 64, 13)),                              # d > 12
    dict(block=513),                                              # block
    dict(block=0),
    dict(block=48),                                               # npad % block
    dict(pts=torch.rand(0, 64, 3), mask=torch.ones(0, 64, dtype=torch.bool)),
    dict(wcap=-1),
])
def test_kernel_argument_checks(bad):
    args = dict(pts=torch.rand(2, 64, 3),
                mask=torch.ones(2, 64, dtype=torch.bool), block=32, wcap=64)
    kernel.check_args(args["pts"], args["mask"], args["block"], args["wcap"])
    args.update(bad)
    with pytest.raises(ValueError):
        kernel.check_args(args["pts"], args["mask"], args["block"],
                          args["wcap"])


def test_sweep_entry_argument_checks():
    x = torch.rand(2, 64, 3)
    m = torch.ones(2, 64, dtype=torch.bool)
    with pytest.raises(ValueError, match="expected"):
        ops.sfs_sweep(x[0], m[0], block=32, wcap=64, sentinel=1.7e38)
    with pytest.raises(ValueError, match="not a multiple"):
        ops.sfs_sweep(x, m, block=48, wcap=64, sentinel=1.7e38)


@pytest.mark.parametrize("cfg_kw,what", [
    (dict(), "WorkerMesh"),
    (dict(merge="tree"), "WorkerMesh"),
])
def test_unported_options_raise(cfg_kw, what):
    """Nothing is left unported: the multi-device mesh runs, the flat and
    the tree merge alike, and a mesh argument that is not a
    `WorkerMesh` raises ``TypeError``; a real mesh (here a world of one)
    gives the one-device answer."""
    from repro_torch.launch.mesh import make_worker_mesh
    x = np.random.default_rng(1).random((40, 3)).astype(np.float32)
    cfg = parallel.SkyConfig(**cfg_kw)
    with pytest.raises(TypeError, match=what):
        api.parallel_skyline(x, cfg=cfg, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match=what):
        parallel.check_supported(cfg, mesh=object())
    got, _ = api.parallel_skyline(x, cfg=cfg,
                                  mesh=make_worker_mesh(device="cpu"))
    want, _ = api.parallel_skyline(x, cfg=cfg, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("cfg_kw", [
    dict(rep_filter="sorted"), dict(rep_filter="region"),
    dict(rep_filter="random"), dict(noseq=True),
    dict(rep_filter="sorted", noseq=True),
    dict(strategy="grid", bucket_factor=8.0),
    dict(strategy="random"),
    dict(strategy="angular", bucket_factor=8.0),
    dict(merge="tree"),
    dict(merge="tree", noseq=True, rep_filter="sorted")])
def test_ported_options_no_longer_raise(cfg_kw):
    """Representative filtering (4b), the flat NoSeq merge (4c), the
    random, grid and angular strategies (4a) and the tree merge on one
    device (4d) run, one-shot and as a streaming insert; the answer is
    the default configuration's."""
    x = np.random.default_rng(1).random((40, 3)).astype(np.float32)
    cfg = parallel.SkyConfig(**cfg_kw)
    got, _ = api.parallel_skyline(x, cfg=cfg, device="cpu")
    want, _ = api.parallel_skyline(x, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    state, _ = api.insert_chunk(api.init_state(cfg, 3, device="cpu"), x,
                                cfg=cfg)
    for g, w in zip(api.finalize(state, cfg=cfg), want):
        assert torch.equal(g, w)


def test_mesh_and_live_state_raise():
    """A mesh that is not a `WorkerMesh` raises ``TypeError`` and a real
    one runs (the mesh raised ``NotImplementedError`` before the
    multi-device slice); a live state takes inserts (it raised before
    the streaming slice)."""
    from repro_torch.launch.mesh import make_worker_mesh
    x = np.random.default_rng(2).random((40, 3)).astype(np.float32)
    with pytest.raises(TypeError, match="WorkerMesh"):
        api.parallel_skyline(x, mesh=object(), device="cpu")
    on_mesh, _ = api.parallel_skyline(x, mesh=make_worker_mesh(device="cpu"))
    assert int(on_mesh.count) > 0
    state, _ = incremental._insert(None, torch.from_numpy(x),
                                   torch.ones(40, dtype=torch.bool),
                                   cfg=parallel.SkyConfig())
    state, stats = incremental._insert(state, torch.from_numpy(x),
                                       torch.ones(40, dtype=torch.bool),
                                       cfg=parallel.SkyConfig())
    assert int(state.chunks) == 2 and int(stats["evicted"]) == 0
    with pytest.raises(ValueError, match="unknown strategy"):
        api.parallel_skyline(x, cfg=parallel.SkyConfig(strategy="nope"),
                             device="cpu")


def test_config_converts_field_for_field():
    for jcfg in (jpar.SkyConfig(), jpar.SkyConfig(p=3, capacity=77,
                                                  block=64, wtile=32)):
        got = convert.config_from_reference(dataclasses.asdict(jcfg))
        assert dataclasses.asdict(got) == dataclasses.asdict(jcfg)
    with pytest.raises(ValueError, match="unknown SkyConfig fields"):
        convert.config_from_reference({"p": 2, "workers": 4})


def test_buffer_round_trip_keeps_bits():
    rng = np.random.default_rng(3)
    pts = rng.random((16, 4)).astype(np.float32)
    pts[3, 1] = -0.0
    pts[5] = np.float32(1.7e38)
    leaves = (pts, rng.random(16) > 0.5, np.int32(9), np.bool_(True))
    buf = convert.buffer_from_numpy(leaves, device="cpu")
    assert buf.points.dtype == torch.float32 and buf.mask.dtype == torch.bool
    back = convert.buffer_to_numpy(buf)
    np.testing.assert_array_equal(back[0].view(np.int32),
                                  pts.view(np.int32))
    for got, want in zip(back[1:], leaves[1:]):
        np.testing.assert_array_equal(got, want)


def test_serve_modules_are_scanned_for_jax():
    """The import scan above covers the serving layer."""
    names = {p.name for p in PORT_FILES if p.parent.name == "serve"}
    assert {"api.py", "slab.py", "engine.py", "scheduler.py",
            "loop.py"} <= names


def test_engine_and_streams_raise_without_cuda(monkeypatch):
    """``SkylineEngine()`` (and the scheduler's default engine) runs on
    the card unless given ``device="cpu"``; without CUDA it raises.  A
    CPU engine's streams keep their arenas on the CPU."""
    from repro_torch.serve import engine as teng
    from repro_torch.serve import scheduler as tsched
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tsched, "_DEFAULT_ENGINE", None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teng.SkylineEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsched.default_engine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsched.admit(tsched.Request(np.ones(3), np.ones(3), np.ones(3)), 2)
    engine = teng.SkylineEngine(device="cpu")
    stream = engine.open_stream(3, teng.StreamOptions(q=2))
    assert all(a.device.type == "cpu" for a in stream.arena.leaves())
    stream.feed([np.random.default_rng(0).random((9, 3)), None])
    assert stream.snapshot()[0].points.device.type == "cpu"


def test_cuda_impl_on_a_cpu_engine_raises():
    from repro_torch.serve import engine as teng
    with pytest.raises(ValueError, match="CUDA tensors only"):
        teng.SkylineEngine(parallel.SkyConfig(impl="cuda"), device="cpu")
    engine = teng.SkylineEngine(device="cpu")
    x = np.random.default_rng(0).random((20, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        engine.submit(teng.SkylineRequest(data=x, impl="cuda"))
