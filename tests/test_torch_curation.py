"""The port's curated training driver (`repro_torch.examples.
train_skyline_curation`) against the repository's own example
(``examples/train_skyline_curation.py``, loaded from its file; nothing
there changes) on the CPU, at a tiny config: 2 layers, d_model 64, 4/2
heads, d_ff 128, vocab 256.

* ``per_example_loss``: f32 at rtol = atol = 1e-5; bf16 norm-wise within
  the reference's own bf16-versus-f32 error (the reference compiled
  without excess precision, as ``tests/test_torch_transformer.py``).
* The curated loop, four steps of batch 4 picked from 8 candidates of
  16 tokens: the reference's loop is rebuilt here from the example's
  ``model_config`` schedule and ``per_example_loss`` with ``repro``'s
  ``make_batch``, ``pareto_select`` and jitted ``make_train_step``.  In
  f32 the port picks the reference's indices at every step, its losses
  are within rtol 1e-5 and its parameters within one learning rate
  (the tolerances of ``tests/test_torch_train_step.py``, whose one step
  at lr 3e-4 holds them at atol 3e-4; the example's lr is 1e-3, and
  after four steps one element of 8,192 in ``wq`` lay 3.3e-4 off:
  Adam's update is sign-like where a gradient is near zero).  In bf16 the
  reference's indices are replayed (one flipped selection changes every
  later step) and the losses and parameters are held norm-wise within
  bf16's own error; the steps whose own selection agrees are printed.
* ``--no-curate``: two steps, held as the f32 loop.

Both packages start from the port's ``init_params(seed=0)`` on the CPU
and read the same token batches (``data.pipeline``).
"""

import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses
import gc
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import assert_bf16_within_own_error, np32, op_by_op
from _torch_train import jax_copy, leaf_paths, at
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import convert
from repro_torch.data.pipeline import DataState, make_batch
from repro_torch.examples import train_skyline_curation as tc
from repro_torch.models import transformer as TT
from repro_torch.models.common import init_params

ROOT = Path(__file__).resolve().parents[1]
STEPS, BATCH, SEQ = 4, 4, 16


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_train_skyline_curation",
        ROOT / "examples" / "train_skyline_curation.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_example()


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends (memory
    mappings; see ``tests/test_torch_scheduler.py``)."""
    yield
    jax.clear_caches()
    gc.collect()


def tiny(compute_dtype):
    """(port config, reference config): the tiny dense model."""
    jcfg = JModelConfig(name="lm-tiny", family="dense", n_layers=2,
                        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                        vocab=256, microbatches=1,
                        compute_dtype=compute_dtype)
    return (convert.model_config_from_reference(dataclasses.asdict(jcfg)),
            jcfg)


def start_params(cfg):
    """The port's parameters at the start of `train`, as JAX arrays."""
    return jax_copy(init_params(TT.lm_plan(cfg), seed=0, device="cpu"))


def reference_loop(jcfg, jparams, *, steps, curate, replay=None,
                   compile_fn=None):
    """The example's loop (``examples/train_skyline_curation.py:67-94``)
    with its functions: (losses, indices per step, final parameters).
    ``replay[i]`` takes the place of step i's selection."""
    from repro.data.pipeline import DataState as JData
    from repro.data.pipeline import make_batch as jmake_batch
    from repro.data.selection import pareto_select as jselect
    from repro.train.optim import OptConfig as JOpt
    from repro.train.step import init_state, make_train_step
    compile_fn = compile_fn or (lambda fn, *a: jax.jit(fn)(*a))
    opt = JOpt(lr=1e-3, total_steps=steps,
               warmup_steps=max(steps // 20, 1))
    state = init_state(jparams, opt)
    step = make_train_step(jcfg, opt)
    losses_of = (lambda p, b: REF.per_example_loss(p, jcfg, b))
    data = JData(seed=1, step=0)
    losses, indices = [], []
    for i in range(steps):
        if curate:
            cand = jmake_batch(jcfg, BATCH * 2, SEQ, data)
            data = data.advance()
            losses_c = compile_fn(losses_of, state["params"], cand)
            lengths = jnp.sum(cand["labels"] >= 0, axis=-1)
            recency = jnp.arange(BATCH * 2, dtype=jnp.float32)
            crit = jnp.stack([-losses_c, -lengths.astype(jnp.float32),
                              recency], axis=-1)
            idx, _ = jselect(crit, BATCH)
            indices.append(np.asarray(idx))
            if replay is not None:
                idx = jnp.asarray(replay[i])
            batch = jax.tree.map(lambda x: x[idx], cand)
        else:
            batch = jmake_batch(jcfg, BATCH, SEQ, data)
            data = data.advance()
        state, metrics = compile_fn(step, state, batch)
        losses.append(float(metrics["loss"]))
    return losses, indices, jax.tree.map(np.asarray, state["params"])


def port_loop(cfg, **kw):
    return tc.train(cfg, steps=kw.pop("steps", STEPS), batch=BATCH, seq=SEQ,
                  device="cpu", **kw)


def selections(out):
    return [idx.numpy() for idx in out.indices]


def assert_params_close(cfg, got, want):
    """Every parameter within one learning rate of the reference's."""
    lr = tc.opt_config(STEPS).lr
    for path in leaf_paths(cfg):
        np.testing.assert_allclose(np32(at(got, path)), at(want, path),
                                   rtol=0, atol=lr, err_msg=str(path))


def test_model_configs_are_the_reference_examples():
    for big in (False, True):
        want = dataclasses.asdict(REF.model_config(big))
        assert dataclasses.asdict(tc.model_config(big)) == want
    assert tc.model_config(True).param_count() == \
        REF.model_config(True).param_count()


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_per_example_loss_matches_reference(compute_dtype):
    cfg, jcfg = tiny(compute_dtype)
    params = init_params(TT.lm_plan(cfg), seed=0, device="cpu")
    jparams = jax_copy(params)
    batch = make_batch(cfg, 8, 16, DataState(3, 0), device="cpu")
    jbatch = {k: jnp.asarray(np.array(v.numpy(), copy=True))
              for k, v in batch.items()}
    with torch.no_grad():
        got = tc.per_example_loss(params, cfg, batch)
    assert got.shape == (8,) and got.dtype == torch.float32
    if compute_dtype == "float32":
        want = jax.jit(lambda p, b: REF.per_example_loss(p, jcfg, b))(
            jparams, jbatch)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        return
    want = op_by_op(lambda p, b: REF.per_example_loss(p, jcfg, b), jparams,
                    jbatch)
    j32 = dataclasses.replace(jcfg, compute_dtype="float32")
    want32 = jax.jit(lambda p, b: REF.per_example_loss(p, j32, b))(
        jparams, jbatch)
    assert_bf16_within_own_error([got], [want], [want32], "per-example loss")


def test_curated_loop_f32_picks_the_reference_indices():
    cfg, jcfg = tiny("float32")
    want_losses, want_idx, want_params = reference_loop(
        jcfg, start_params(cfg), steps=STEPS, curate=True)
    out = port_loop(cfg, curate=True)
    got_idx = selections(out)
    assert len(got_idx) == STEPS
    for i, (g, w) in enumerate(zip(got_idx, want_idx)):
        assert g.dtype == np.int32 and g.tolist() == w.tolist(), (i, g, w)
    np.testing.assert_allclose(out.losses, want_losses, rtol=1e-5)
    assert_params_close(cfg, out.state["params"], want_params)
    assert int(out.state["step"]) == STEPS
    for crit, front in zip(out.criteria, out.fronts):
        assert crit.shape == (2 * BATCH, 3) and front.shape == (2 * BATCH,)
    assert set(out.phase_ms) == set(tc.PHASES)


def test_curated_loop_bf16_with_replayed_indices():
    """bf16: the port replays the reference's indices; its losses and
    final parameters lie within the reference's own bf16 error (its
    distance from its f32 run on the same indices).  How many steps the
    port's own selection agrees with the reference's, with and without
    replay, is printed and not asserted."""
    cfg, jcfg = tiny("bfloat16")
    jparams = start_params(cfg)
    want_losses, want_idx, want_params = reference_loop(
        jcfg, jparams, steps=STEPS, curate=True, compile_fn=op_by_op)
    j32 = dataclasses.replace(jcfg, compute_dtype="float32")
    f32_losses, _, f32_params = reference_loop(
        j32, jparams, steps=STEPS, curate=True, replay=want_idx)
    out = port_loop(cfg, curate=True, replay=want_idx)
    assert_bf16_within_own_error([np.asarray(out.losses)],
                                 [np.asarray(want_losses)],
                                 [np.asarray(f32_losses)], "losses")
    paths = leaf_paths(cfg)
    assert_bf16_within_own_error(
        [at(out.state["params"], p) for p in paths],
        [at(want_params, p) for p in paths],
        [at(f32_params, p) for p in paths], "parameters")
    replayed = sum(g.tolist() == w.tolist()
                   for g, w in zip(selections(out), want_idx))
    free = port_loop(cfg, curate=True)
    own = sum(g.tolist() == w.tolist()
              for g, w in zip(selections(free), want_idx))
    print(f"bf16: own selection equals the reference's at {replayed} of "
          f"{STEPS} steps on the reference's trajectory, {own} of {STEPS} "
          f"without replay")


def test_no_curate_matches_reference():
    cfg, jcfg = tiny("float32")
    want_losses, _, want_params = reference_loop(
        jcfg, start_params(cfg), steps=2, curate=False)
    out = port_loop(cfg, steps=2, curate=False)
    assert out.indices == [None, None] and out.criteria == []
    np.testing.assert_allclose(out.losses, want_losses, rtol=1e-5)
    assert_params_close(cfg, out.state["params"], want_params)
