"""The port's checkpoint manager against ``repro.checkpoint.manager``.

The counterpart of ``tests/test_train_infra.py::
test_checkpoint_roundtrip_and_gc`` on a nested state of f32, bf16 and
int32 leaves (dicts, lists and a named tuple), and the cross-package
case both ways: file names, the manifest's keys and every bit equal.
The reference cannot restore a bf16 leaf, its own or the port's (numpy
saves ml_dtypes' bfloat16 as ``<V2`` and cannot cast it back): that
direction is held on f32 and int32 leaves, and the port reads the
reference's bf16 files.  Tolerance: zero.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jman
from repro_torch.checkpoint import manager as tman

Moments = collections.namedtuple("Moments", "mu nu")


def _host(seed=0, bf16=True):
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 4)).astype(np.float32)
    f32[0, 0] = -0.0
    return {"params": {"w": f32, "b": [rng.standard_normal(4).astype(
                np.float32), np.arange(5, dtype=np.int32)]},
            "opt": Moments(rng.standard_normal((2, 2)).astype(np.float32),
                           rng.standard_normal(6).astype(np.float32)),
            "step": np.int32(7),
            "half": rng.standard_normal(5).astype(np.float32) if bf16
            else None}


def _torch_state(host):
    out = {"params": {"w": torch.from_numpy(host["params"]["w"]),
                      "b": [torch.from_numpy(x) for x in
                            host["params"]["b"]]},
           "opt": Moments(*(torch.from_numpy(x) for x in host["opt"])),
           "step": torch.tensor(host["step"])}
    if host["half"] is not None:
        out["half"] = torch.from_numpy(host["half"]).to(torch.bfloat16)
    return out


def _jax_state(host):
    out = jax.tree.map(jnp.asarray, {k: v for k, v in host.items()
                                     if k != "half"})
    out["opt"] = Moments(*(jnp.asarray(x) for x in host["opt"]))
    if host["half"] is not None:
        out["half"] = jnp.asarray(host["half"], jnp.bfloat16)
    return out


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        x = x.numpy()
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _leaves(state):
    return [v for _, v in sorted(tman._flatten(state).items())]


def test_checkpoint_roundtrip_and_gc(tmp_path):
    state = _torch_state(_host())
    d = str(tmp_path / "ck")
    tman.save(d, 7, state, {"data_seed": 5, "data_step": 7})
    got, step, extra = tman.restore(d, state)
    assert step == 7 and extra == {"data_seed": 5, "data_step": 7}
    assert isinstance(got["opt"], Moments)
    for a, b in zip(_leaves(got), _leaves(state), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))

    mgr = tman.CheckpointManager(d, keep=2, async_save=False)
    for s in (8, 9, 10):
        mgr.save(s, state)
    steps = sorted(int(x.split("_")[1]) for x in os.listdir(d)
                   if x.startswith("step_"))
    assert steps == [9, 10] and tman.latest_step(d) == 10


def test_async_save_copies_before_writing(tmp_path):
    state = _torch_state(_host())
    want = _bits(state["params"]["w"]).copy()
    mgr = tman.CheckpointManager(str(tmp_path / "ck"), keep=1)
    mgr.save(1, state)
    state["params"]["w"].fill_(3.0)     # the caller writes in place
    got, step, _ = mgr.restore(_torch_state(_host()))
    assert step == 1
    np.testing.assert_array_equal(_bits(got["params"]["w"]), want)


def test_file_names_and_keys_are_the_references(tmp_path):
    host = _host()
    tman.save(str(tmp_path / "t"), 3, _torch_state(host))
    jman.save(str(tmp_path / "j"), 3, _jax_state(host))
    tdir, jdir = tmp_path / "t" / "step_3", tmp_path / "j" / "step_3"
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    tkeys = (tdir / "manifest.json").read_text()
    assert tkeys == (jdir / "manifest.json").read_text()
    for name in os.listdir(jdir):
        if name.endswith(".npy"):
            assert (tdir / name).read_bytes() == (jdir / name).read_bytes()
    keyed, _ = jman._flatten(_jax_state(host))
    assert list(tman._flatten(_torch_state(host))) == list(keyed)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    host = _host(1)
    d = str(tmp_path / "j")
    jman.save(d, 4, _jax_state(host), {"cursor": 12})
    target = _torch_state(_host(2))
    got, step, extra = tman.restore(d, target)
    assert (step, extra) == (4, {"cursor": 12})
    want = _torch_state(host)
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    host = _host(1, bf16=False)
    d = str(tmp_path / "t")
    tman.save(d, 6, _torch_state(host), {"cursor": 3})
    got, step, extra = jman.restore(d, _jax_state(_host(2, bf16=False)))
    assert (step, extra) == (6, {"cursor": 3})
    keyed, _ = jman._flatten(got)
    want = tman._flatten(_torch_state(host))
    assert list(keyed) == list(want)
    for key, leaf in keyed.items():
        np.testing.assert_array_equal(_bits(leaf), _bits(want[key]))


def test_restore_places_leaves_where_asked(tmp_path, monkeypatch):
    state = _torch_state(_host(bf16=False))
    d = str(tmp_path / "ck")
    tman.save(d, 1, state)
    got, _, _ = tman.restore(d, state, shardings="cpu")
    assert all(x.device.type == "cpu" for x in _leaves(got))
    devs = jax.tree.map(lambda _: "cpu", {k: v for k, v in
                                          _host(bf16=False).items()
                                          if v is not None})
    devs["opt"] = Moments("cpu", "cpu")
    got, _, _ = tman.restore(d, state, shardings=devs)
    assert all(x.device.type == "cpu" for x in _leaves(got))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tman.restore(d, {"step": np.int32(0)})
    with pytest.raises(FileNotFoundError):
        tman.restore(str(tmp_path / "none"), state)
