"""Rules the port keeps: it imports no JAX, its entry points run on the
card unless asked for the CPU, its kernel runs on CUDA tensors only and
checks its arguments, unported options raise, and state crosses between
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
                                   "skyline_mask_exact"])
def test_entry_points_raise_without_cuda(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).random((50, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(api, entry)(x)
    getattr(api, entry)(x, device="cpu")   # the CPU only when asked


def test_auto_follows_the_data():
    assert backend.resolve_spec("auto", torch.device("cpu")).sweep == "torch"
    assert backend.resolve_spec("auto", torch.device("cuda")).sweep == "cuda"
    for impl in ("torch", "perpair"):
        assert backend.resolve_spec(impl, torch.device("cuda")).sweep == impl
    with pytest.raises(ValueError, match="unknown kernel backend"):
        backend.resolve_spec("jnp", torch.device("cpu"))


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
    (dict(strategy="grid"), "strategy 'grid'"),
    (dict(strategy="random"), "strategy 'random'"),
    (dict(strategy="angular"), "strategy 'angular'"),
    (dict(rep_filter="sorted"), "representative filtering"),
    (dict(noseq=True), "NoSeq"),
    (dict(merge="tree"), "tree merge"),
])
def test_unported_options_raise(cfg_kw, what):
    x = np.random.default_rng(1).random((40, 3)).astype(np.float32)
    with pytest.raises(NotImplementedError, match=what):
        api.parallel_skyline(x, cfg=parallel.SkyConfig(**cfg_kw),
                             device="cpu")


def test_mesh_and_live_state_raise():
    x = np.random.default_rng(2).random((40, 3)).astype(np.float32)
    with pytest.raises(NotImplementedError, match="mesh"):
        api.parallel_skyline(x, mesh=object(), device="cpu")
    state, _ = incremental._insert(None, torch.from_numpy(x),
                                   torch.ones(40, dtype=torch.bool),
                                   cfg=parallel.SkyConfig())
    with pytest.raises(NotImplementedError, match="live SkylineState"):
        incremental._insert(state, torch.from_numpy(x),
                            torch.ones(40, dtype=torch.bool),
                            cfg=parallel.SkyConfig())
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
