"""The port's train step (`repro_torch.train.step`) against
``repro.train.step`` on the CPU.

* Port only, each of the ten smoke configs (the train-step half of
  ``tests/test_models_smoke.py``): one step with two microbatches gives
  a finite loss and gradient norm, advances the step counter and moves
  the parameters; ``remat=True`` gives the same state and metrics as
  ``remat=False`` bit for bit (recomputation repeats the same
  operations).
* Gradients against the reference's ``value_and_grad`` of ``loss_fn``
  (``remat=False`` on the reference side, to keep compiles short), the
  six attention-only configs here, the other four in
  ``tests/test_torch_train_grads.py``.  f32 compute: the loss within
  1e-5 relative, each leaf norm-wise within 2e-3 of the reference's
  (XLA's and torch's sums run in other orders; llama4's init makes
  attention nearly an argmax).  bf16 compute: each leaf's distance from
  the reference compiled without excess precision at most the
  reference's own distance from its f32 gradient, with a floor of 1e-3
  of the f32 gradient's norm; MoE routing recorded in the reference's
  bf16 run, taken by its f32 run and replayed in the port.  Mamba-2's
  block also alone, at an input where the reference's bf16 SiLU
  rounding matters (the regression of its bf16 gradients).
* ``_split_micro`` and ``init_state`` bit for bit; one step with two
  microbatches against the reference's jitted step (loss 1e-5, the
  parameters within one learning rate); ``shard_activations=True``
  raises, naming ROADMAP item 14c.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import op_by_op
from _torch_train import (at, batch_pair, check_bf16_gradients,
                          check_f32_gradients, clear_reference_gradients,
                          dist, jax_copy, leaf_paths, norm,
                          one_torch_thread, setup, state_bits)
from repro.configs import ARCH_NAMES
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import transformer as TT
from repro_torch.train import step as tstep
from repro_torch.train.optim import OptConfig


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends (memory
    mappings; see ``tests/test_torch_scheduler.py``), and run on one
    torch thread meanwhile."""
    restore = one_torch_thread()
    yield
    restore()
    clear_reference_gradients()
    jax.clear_caches()
    gc.collect()


# -- port only: the reference's smoke train step, and remat ---------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_smoke_train_step(arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True), microbatches=2)
    _, _, params, _ = setup(arch)
    batch, _ = batch_pair(cfg)
    with torch.no_grad():
        logits, _, _ = TT.forward(params, cfg, batch)
    assert tuple(logits.shape) == (4, 32, cfg.vocab_padded)
    assert bool(torch.isfinite(logits).all())

    before = [p.clone() for p in jax.tree.leaves(params)]
    opt = OptConfig(total_steps=10, warmup_steps=1)
    state = tstep.init_state(params, opt)
    state, metrics = tstep.make_train_step(cfg, opt)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert int(state["step"]) == 1 and state["step"].dtype == torch.int32
    assert all(m.dim() == 0 for m in metrics.values())
    delta = sum(float((a - b).abs().sum()) for a, b in
                zip(jax.tree.leaves(state["params"]), before))
    assert delta > 0


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_remat_is_bit_for_bit(arch):
    opt = OptConfig(total_steps=10, warmup_steps=1)
    out = []
    for remat in (True, False):
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  microbatches=2, remat=remat)
        _, _, params, _ = setup(arch)
        batch, _ = batch_pair(cfg, b=2, s=16)
        state, metrics = tstep.make_train_step(cfg, opt)(
            tstep.init_state(params, opt), batch)
        out.append((state_bits(state), state_bits(metrics)))
    assert out[0] == out[1]


# -- gradients against the reference (the attention-only configs; the
# SSM and MoE configs are in tests/test_torch_train_grads.py) -----------

GRAD_ARCHS = ["yi-6b", "qwen3-14b", "phi4-mini-3.8b", "starcoder2-7b",
              "hubert-xlarge", "paligemma-3b"]


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_f32_gradients_match_reference(arch, monkeypatch):
    check_f32_gradients(arch, monkeypatch)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_bf16_gradients_within_own_error(arch, monkeypatch):
    check_bf16_gradients(arch, monkeypatch)


def test_mamba2_block_bf16_gradients():
    """Mamba-2's block alone in bf16, at an input whose early positions
    nearly cancel the skip term (``y ≈ -D·x``), so the gated RMSNorm
    amplifies every rounding of the SiLU: the port's input gradient and
    parameter gradients stay within the reference's own bf16 error.
    With ``F.silu`` in the block (one rounding from f32, not the
    reference's step-by-step rounding) the input gradient's distance was
    1.31x the bound (15.45 against 11.81)."""
    import ml_dtypes
    from repro.models import ssm as jssm
    from repro_torch.models import ssm as tssm
    from repro_torch.models.common import init_params
    h, p, n, d = 4, 16, 16, 64
    params = init_params(tssm.mamba2_plan(d, h, p, n), seed=0, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 32, d)).astype(ml_dtypes.bfloat16)
    gout = rng.standard_normal((4, 32, d)).astype(np.float32)
    kw = dict(n_heads=h, head_dim=p, state=n, chunk=8)

    def jloss(prm, xx, dt):
        y, _ = jssm.mamba2_apply(prm, xx, compute_dtype=dt, **kw)
        return jnp.sum(y.astype(jnp.float32) * gout)

    jp = jax_copy(params)
    grad = jax.grad(jloss, argnums=(0, 1))
    want = op_by_op(lambda a, b: grad(a, b, jnp.bfloat16), jp,
                    jnp.asarray(x))
    want32 = jax.jit(lambda a, b: grad(a, b, jnp.float32))(
        jp, jnp.asarray(x).astype(jnp.float32))

    tp = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    tx = torch.from_numpy(x.view(np.int16).copy()).view(
        torch.bfloat16).requires_grad_(True)
    y, _ = tssm.mamba2_apply(tp, tx, compute_dtype=torch.bfloat16, **kw)
    torch.sum(y.float() * torch.from_numpy(gout)).backward()
    pairs = [(tx.grad, want[1], want32[1], "x")] + [
        (tp[k].grad, want[0][k], want32[0][k], k) for k in sorted(tp)]
    for g, w, w32, name in pairs:
        bound = max(dist(w, w32), 1e-3 * norm(w32))
        assert dist(g, w) <= bound, (name, dist(g, w), bound)


# -- the step's pieces and one step against the reference -----------------

def test_split_micro_and_init_state_bit_for_bit():
    from repro.train import step as jstep
    from repro.train.optim import OptConfig as JOpt
    cfg, _, params, jparams = setup("paligemma-3b")
    batch, jbatch = batch_pair(cfg)
    got = tstep._split_micro(batch, 2)
    want = jstep._split_micro(jbatch, 2)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for compress in (None, "int8"):
        for mdt in ("float32", "bfloat16"):
            kw = dict(moment_dtype=mdt, compress=compress)
            st = tstep.init_state(params, OptConfig(**kw))
            jst = jstep.init_state(jparams, JOpt(**kw))
            back = convert.train_state_from_numpy(
                jax.tree.map(np.asarray, jst), device="cpu")
            assert state_bits(st) == state_bits(back)


@pytest.mark.parametrize("arch", ["yi-6b"])
def test_train_step_matches_reference(arch):
    """One f32 step with two microbatches: the metrics and the updated
    parameters against the reference's jitted ``make_train_step``."""
    from repro.train import step as jstep
    from repro.train.optim import OptConfig as JOpt
    kw = dict(total_steps=10, warmup_steps=2)
    cfg, jcfg, params, jparams = setup(arch, microbatches=2,
                                       compute_dtype="float32")
    batch, jbatch = batch_pair(cfg, b=8)
    jstate = jstep.init_state(jparams, JOpt(**kw))
    jnew, jm = jax.jit(jstep.make_train_step(jcfg, JOpt(**kw)))(jstate,
                                                                 jbatch)
    jnew = jax.tree.map(np.asarray, jnew)
    state, metrics = tstep.make_train_step(cfg, OptConfig(**kw))(
        tstep.init_state(params, OptConfig(**kw)), batch)
    assert sorted(metrics) == sorted(jm)
    for key in ("ce_loss", "loss"):
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]),
                                   rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jm["grad_norm"]), rtol=2e-3)
    np.testing.assert_allclose(float(metrics["lr"]), float(jm["lr"]),
                               rtol=1e-6)
    assert int(state["step"]) == int(jnew["step"]) == 1
    for path in leaf_paths(cfg):
        np.testing.assert_allclose(at(state["params"], path).numpy(),
                                   at(jnew["params"], path), rtol=0,
                                   atol=3e-4, err_msg=str(path))


def test_shard_activations_builds_a_step():
    """``shard_activations=True`` builds the sharded train and eval
    steps; on a 1 x 1 mesh (a world of one) they give the unsharded
    steps' state, loss and metrics bit for bit."""
    from repro_torch.configs import arch_rules
    from repro_torch.data.pipeline import DataState, make_batch
    from repro_torch.launch.mesh import DTensor, make_local_mesh, set_mesh
    from repro_torch.models.common import init_params
    cfg = get_config("yi-6b", smoke=True)
    opt = OptConfig(total_steps=10, warmup_steps=1)
    params = init_params(TT.lm_plan(cfg), seed=0, device="cpu")
    batch = make_batch(cfg, 4, 16, DataState(0, 0), device="cpu")
    s1, m1 = tstep.make_train_step(cfg, opt)(
        tstep.init_state(TT.tree_map(torch.clone, params), opt), batch)
    e1 = tstep.make_eval_step(cfg)(s1["params"], batch)
    mesh = make_local_mesh(1, 1, device="cpu")
    rules = arch_rules(cfg, "train_4k", model_axis=1, data_axis=1)
    with set_mesh(mesh):
        step = tstep.make_train_step(cfg, opt, rules=rules,
                                     shard_activations=True)
        s2, m2 = step(tstep.init_state(params, opt), batch)
        e2 = tstep.make_eval_step(cfg, rules=rules, shard_activations=True)(
            s2["params"], batch)
    assert isinstance(s2["params"]["embed"], DTensor)
    assert state_bits(s1) == state_bits(TT.tree_map(
        lambda t: t.to_local() if isinstance(t, DTensor) else t, s2))
    for ours, theirs in ((m1, m2), (e1, e2)):
        assert ours.keys() == theirs.keys()
        for k in ours:
            assert torch.equal(ours[k], theirs[k]), k


def test_eval_step_matches_reference():
    from repro.train import step as jstep
    cfg, jcfg, params, jparams = setup("yi-6b", compute_dtype="float32")
    batch, jbatch = batch_pair(cfg)
    got = tstep.make_eval_step(cfg)(params, batch)
    want = jax.jit(jstep.make_eval_step(jcfg))(jparams, jbatch)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5)
