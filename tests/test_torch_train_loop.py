"""The port's training driver (`repro_torch.launch.train`) and its train
state's checkpoints on the CPU, against ``repro.launch.train`` and the
infrastructure half of ``tests/test_train_infra.py`` (all of it but
``test_zero1_specs_add_data_axis``, which is ROADMAP item 14c).

* Bit for bit in the port (its CPU path is deterministic; the reference
  holds atol 1e-6): 20 straight steps against 10 steps, a restart and 10
  more from the checkpoint; a run with ``fail_at`` that restores its
  last checkpoint and replays; ``convert.train_state_to_numpy`` and back.
* The trajectory against the reference's ``train_loop`` (its
  ``init_params`` patched to return copies of the port's parameters), f32,
  10 steps, on two configs: every loss within 1e-4 and the final
  parameters within one learning rate, 3e-4 (Adam's early steps are
  sign-like, so a gradient within noise of zero can flip an update;
  measured within 5.6e-5).
* Checkpoints of a train state with f32 moments written by either
  package and restored by the other, bit for bit (the reference cannot
  restore bf16 leaves: ROADMAP queue 3).
* The command line with ``--device cpu``, and its ``RuntimeError``
  without CUDA.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses
import gc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import at, leaf_paths, one_torch_thread, setup, state_bits
from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager, restore, save
from repro_torch.configs import get_config
from repro_torch.launch import train as ttrain
from repro_torch.train import step as tstep
from repro_torch.train.optim import OptConfig


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends (memory
    mappings; see ``tests/test_torch_scheduler.py``), and run on one
    torch thread meanwhile."""
    restore_threads = one_torch_thread()
    yield
    restore_threads()
    jax.clear_caches()
    gc.collect()


CFG = get_config("mamba2-780m", smoke=True)
OPT = OptConfig(total_steps=20, warmup_steps=2)


def _loop(**kw):
    kw = dict(dict(steps=20, batch=4, seq=32, opt_cfg=OPT, log_every=100,
                   device="cpu"), **kw)
    return ttrain.train_loop(CFG, **kw)


@pytest.fixture(scope="module")
def straight():
    return _loop()[0]


def test_train_resume_is_bit_for_bit(straight, tmp_path):
    """20 straight steps == 10 steps + restart + 10 steps (the same data
    cursor, the same final state)."""
    d = str(tmp_path / "ck")
    _loop(steps=10, ckpt_dir=d, ckpt_every=10)
    resumed, _ = _loop(ckpt_dir=d, ckpt_every=10)
    assert int(resumed["step"]) == 20
    assert state_bits(resumed) == state_bits(straight)


def test_fail_at_replays_bit_for_bit(straight, tmp_path, capsys):
    state, _ = _loop(ckpt_dir=str(tmp_path / "ck"), ckpt_every=5,
                     fail_at=13)
    out = capsys.readouterr().out
    assert ("[train] step 13 failed (injected failure (test)); restoring "
            "last checkpoint and replaying") in out
    assert state_bits(state) == state_bits(straight)


def test_fail_without_checkpoint_raises():
    with pytest.raises(RuntimeError, match="injected failure"):
        _loop(steps=2, fail_at=1)


def test_checkpoint_roundtrip_and_gc(tmp_path):
    """tests/test_train_infra.py, on the port's train state."""
    _, _, params, _ = setup("mamba2-780m")
    state = tstep.init_state(params, OptConfig())
    d = str(tmp_path / "ck")
    save(d, 7, state, {"data_seed": 5, "data_step": 7})
    got, step, extra = restore(d, state)
    assert step == 7 and extra == {"data_seed": 5, "data_step": 7}
    assert state_bits(got) == state_bits(state)
    mgr = CheckpointManager(d, keep=2, async_save=False)
    for s in (8, 9, 10):
        mgr.save(s, state)
    steps = sorted(int(x.split("_")[1]) for x in os.listdir(d)
                   if x.startswith("step_"))
    assert steps == [9, 10]


def _stepped_state(moment_dtype="float32", compress=None):
    """The port's yi-6b smoke train state after one step (nonzero
    moments and errors)."""
    cfg, _, params, _ = setup("yi-6b", compute_dtype="float32")
    opt = OptConfig(total_steps=10, warmup_steps=1, moment_dtype=moment_dtype,
                    compress=compress)
    from _torch_train import batch_pair
    batch, _ = batch_pair(cfg, b=2, s=16)
    state, _ = tstep.make_train_step(cfg, opt)(tstep.init_state(params, opt),
                                               batch)
    return state


@pytest.mark.parametrize("kw", [{}, {"moment_dtype": "bfloat16",
                                     "compress": "int8"}],
                         ids=["f32", "bf16-int8"])
def test_train_state_numpy_roundtrip(kw):
    state = _stepped_state(**kw)
    host = convert.train_state_to_numpy(state)
    before = state_bits(state)
    state["params"]["embed"].add_(1.0)     # the host copy is its own
    back = convert.train_state_from_numpy(host, device="cpu")
    assert state_bits(back) == before


def test_checkpoints_cross_packages(tmp_path):
    """A train state with f32 moments: the port's checkpoint restored by
    the reference, and the reference's by the port, bit for bit."""
    from repro.checkpoint import manager as jman
    from repro.train import step as jstep
    from repro.train.optim import OptConfig as JOpt
    state = _stepped_state()
    _, _, _, jparams = setup("yi-6b")
    jtarget = jstep.init_state(jparams, JOpt())
    save(str(tmp_path / "port"), 1, state, {"data_seed": 1, "data_step": 1})
    jgot, step, extra = jman.restore(str(tmp_path / "port"), jtarget)
    assert step == 1 and extra == {"data_seed": 1, "data_step": 1}
    back = convert.train_state_from_numpy(jax.tree.map(np.asarray, jgot),
                                          device="cpu")
    assert state_bits(back) == state_bits(state)

    jstate = jax.tree.map(lambda a: jnp.asarray(a),
                          convert.train_state_to_numpy(state))
    jman.save(str(tmp_path / "ref"), 3, jstate, {"data_seed": 2,
                                                 "data_step": 3})
    target = tstep.init_state(setup("yi-6b")[2], OptConfig())
    got, step, extra = restore(str(tmp_path / "ref"), target)
    assert step == 3 and extra == {"data_seed": 2, "data_step": 3}
    assert state_bits(got) == state_bits(state)


@pytest.mark.parametrize("arch", ["mamba2-780m", "yi-6b"])
def test_trajectory_matches_reference(arch, monkeypatch):
    from repro.launch import train as jtrain
    from repro.train.optim import OptConfig as JOpt
    from _torch_train import jax_copy
    cfg, jcfg, params, _ = setup(arch, compute_dtype="float32")
    kw = dict(steps=10, batch=8, seq=32, log_every=1)
    opt = dict(lr=3e-4, warmup_steps=2, total_steps=10)
    monkeypatch.setattr(jtrain, "init_params",
                        lambda plan, key: jax_copy(params))
    jstate, jhist = jtrain.train_loop(jcfg, opt_cfg=JOpt(**opt), **kw)
    state, hist = ttrain.train_loop(cfg, opt_cfg=OptConfig(**opt),
                                    device="cpu", **kw)
    assert [s for s, _ in hist] == [s for s, _ in jhist] == list(
        range(1, 11))
    np.testing.assert_allclose([v for _, v in hist], [v for _, v in jhist],
                               rtol=0, atol=1e-4)
    for path in leaf_paths(cfg):
        np.testing.assert_allclose(at(state["params"], path).numpy(),
                                   np.asarray(at(jstate["params"], path)),
                                   rtol=0, atol=3e-4, err_msg=str(path))


def test_cli_on_the_cpu(tmp_path, capsys):
    state, history = ttrain.main([
        "--arch", "yi-6b", "--smoke", "--steps", "6", "--batch", "2",
        "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every",
        "2", "--fail-at", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] step 3 failed" in out and "[train] done 6 steps" in out
    assert int(state["step"]) == 6 and np.isfinite(history[-1][1])
    assert all(t.device.type == "cpu" for t in
               jax.tree.leaves(state["params"]))


def test_cli_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--arch", "yi-6b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.train_loop(dataclasses.replace(CFG), steps=1, batch=2,
                          seq=16)
