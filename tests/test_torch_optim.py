"""The port's optimizer (`repro_torch.train.optim`) against
``repro.train.optim`` on the CPU, and the optimizer half of
``tests/test_train_infra.py``.

* Bit for bit: ``OptConfig``'s fields and defaults; ``adamw_init``'s
  tree (zeros, the moments' dtype, a 0-d int32 step, the error buffers
  under int8); ``quantize_int8`` / ``dequantize_int8`` (max, abs,
  round half to even, clip: the same IEEE operations).
* rtol 1e-6 (two ulp): ``cosine_lr`` over 1,001 steps and the bias
  corrections ``b ** step`` over 5,000 (XLA's ``cos`` and ``pow`` are its
  own approximations; the reference's own jitted and eager learning
  rates already differ in the last bit); ``clip_by_global_norm``'s norm
  and scaled leaves; ``adamw_update`` with f32 moments, bf16 moments and
  ``compress="int8"``, three steps on the same gradients as the eager
  reference (the elementwise update is written in the reference's
  order, so only those scalars can differ).
* The port's in-place update bit for bit its out-of-place one, which
  leaves its inputs untouched.
* A parameter without a gradient (hubert's ``embed``, which the
  encoder's loss does not reach) is decayed and its moments kept at
  zero, as the reference's zero gradient does, in one train step against
  the reference's.
"""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from _torch_train import (at, batch_pair, leaf_paths, one_torch_thread,
                          setup, state_bits)
from repro.train import optim as jopt
from repro_torch import convert
from repro_torch.data.pipeline import DataState, next_batch
from repro_torch.train import optim as topt
from repro_torch.train import step as tstep


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends (memory
    mappings; see ``tests/test_torch_scheduler.py``), and run on one
    torch thread meanwhile."""
    restore = one_torch_thread()
    yield
    restore()
    jax.clear_caches()
    gc.collect()


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.detach().float().numpy()


def test_opt_config_fields_match_reference():
    got = [(f.name, f.default) for f in dataclasses.fields(topt.OptConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(jopt.OptConfig)]
    assert got == want


def test_cosine_lr_and_bias_corrections():
    cfg = topt.OptConfig(lr=3e-4, warmup_steps=37, total_steps=1000)
    steps = np.arange(1001, dtype=np.int32)
    got = topt.cosine_lr(torch.from_numpy(steps), cfg).numpy()
    want = np.asarray(jopt.cosine_lr(jnp.asarray(steps),
                                     jopt.OptConfig(**dataclasses.asdict(
                                         cfg))))
    assert got.dtype == np.float32
    # near the schedule's end 1 + cos(pi t) cancels: relative to the
    # peak rate (measured: 9.1e-12 absolute, 4.4e-5 of the value there)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * cfg.lr)
    assert float(topt.cosine_lr(0, cfg)) == 0.0
    s = np.arange(1, 5000, dtype=np.float32)
    for b in (0.9, 0.95, 0.999):
        np.testing.assert_allclose(
            (1 - b ** torch.from_numpy(s)).numpy(),
            np.asarray(1 - b ** jnp.asarray(s)), rtol=1e-6, atol=0)


def _tree(seed, shapes=((3, 5), (7,), (2, 2, 4))):
    rng = np.random.default_rng(seed)
    return {f"w{i}": rng.standard_normal(s).astype(np.float32)
            for i, s in enumerate(shapes)}


@pytest.mark.parametrize("kw", [{}, {"moment_dtype": "bfloat16"},
                                {"compress": "int8"}],
                         ids=["f32", "bf16-moments", "int8"])
def test_adamw_init_bit_for_bit(kw):
    params = _tree(0)
    got = topt.adamw_init({k: torch.from_numpy(v) for k, v in
                           params.items()}, topt.OptConfig(**kw))
    want = jopt.adamw_init({k: jnp.asarray(v) for k, v in params.items()},
                           jopt.OptConfig(**kw))
    back = convert.train_state_from_numpy(jax.tree.map(np.asarray, want),
                                          device="cpu")
    assert sorted(got) == sorted(back)
    assert state_bits(got) == state_bits(back)


@pytest.mark.parametrize("kw", [{}, {"moment_dtype": "bfloat16"},
                                {"compress": "int8"},
                                {"clip_norm": 0.5, "weight_decay": 0.0}],
                         ids=["f32", "bf16-moments", "int8", "clipped"])
def test_adamw_update_matches_eager_reference(kw):
    """Three updates on the same gradients, each leaf against the
    reference run op by op (``jax.disable_jit``)."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, **kw)
    params = _tree(1)
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jp = {k: jnp.asarray(v.copy()) for k, v in params.items()}
    st = topt.adamw_init(p, topt.OptConfig(**kw))
    jst = jopt.adamw_init(jp, jopt.OptConfig(**kw))
    for i in range(3):
        grads = _tree(10 + i)
        with jax.disable_jit():
            jp, jst, jm = jopt.adamw_update(
                {k: jnp.asarray(v) for k, v in grads.items()}, jst, jp,
                jopt.OptConfig(**kw))
        p, st, m = topt.adamw_update(
            {k: torch.from_numpy(v) for k, v in grads.items()}, st, p,
            topt.OptConfig(**kw))
        assert int(st["step"]) == int(jst["step"]) == i + 1
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-6)
        for name in ("m", "v") + (("err",) if "compress" in kw else ()):
            for k in params:
                assert st[name][k].dtype == getattr(
                    torch, str(jst[name][k].dtype))
                _close(st[name][k], jst[name][k], f"{name} {k}")
        for k in params:
            _close(p[k], jp[k], k)


def _close(got, want, what):
    """rtol 1e-6, and 1e-6 of the leaf's largest value: a moment that
    sums terms of both signs cancels, so a last-bit difference in the
    global norm (a sum in another order) grows relative to it
    (measured: 1.3e-6 of one first moment's value, 4.7e-10
    absolute)."""
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, rtol=1e-6,
                               atol=1e-6 * float(np.abs(w).max()),
                               err_msg=what)


@pytest.mark.parametrize("kw", [{}, {"moment_dtype": "bfloat16"},
                                {"compress": "int8"}],
                         ids=["f32", "bf16-moments", "int8"])
def test_in_place_equals_out_of_place(kw):
    cfg = topt.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10, **kw)
    params = {k: torch.from_numpy(v) for k, v in _tree(2).items()}
    state = topt.adamw_init(params, cfg)
    state["m"]["w0"].fill_(0.25)
    grads = {k: torch.from_numpy(v) for k, v in _tree(3).items()}
    grads["w1"] = None
    snap = state_bits((params, state, grads["w0"]))

    p2, s2, m2 = topt.adamw_update(grads, state, params, cfg, donate=False)
    assert state_bits((params, state, grads["w0"])) == snap
    p1, s1, m1 = topt.adamw_update(grads, state, params, cfg)
    assert p1["w0"] is params["w0"] and s1["m"]["w2"] is state["m"]["w2"]
    assert state_bits((p1, s1, m1)) == state_bits((p2, s2, m2))


def test_adamw_matches_numpy_reference():
    """tests/test_train_infra.py's numpy check, on the port."""
    opt = topt.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10 ** 9,
                         b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
                         clip_norm=1e9)
    w = np.asarray([[1.0, -2.0], [0.5, 3.0]], np.float32)
    gn = np.asarray([[0.1, 0.2], [-0.3, 0.4]], np.float32)
    p = {"w": torch.from_numpy(w.copy())}
    new_p, _, _ = topt.adamw_update({"w": torch.from_numpy(gn)},
                                    topt.adamw_init(p, opt), p, opt)
    lr = float(topt.cosine_lr(1, opt))
    m, v = 0.1 * gn, 0.001 * gn * gn
    want = w - lr * ((m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.999)) + 1e-8)
                     + 0.01 * w)
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-5)


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 3.0), "b": torch.full((10,), 4.0)}
    clipped, gnorm = topt.clip_by_global_norm(g, 1.0)
    assert abs(float(gnorm) - np.sqrt(250.0)) < 1e-4
    total = np.sqrt(sum(float((x ** 2).sum()) for x in clipped.values()))
    assert abs(total - 1.0) < 1e-5
    # against the reference, leaves of mixed dtypes, in its leaf order
    tree = _tree(4)
    tg = {k: torch.from_numpy(v) for k, v in tree.items()}
    tg["w1"] = tg["w1"].to(torch.bfloat16)
    jg = {k: jnp.asarray(v) for k, v in tree.items()}
    jg["w1"] = jg["w1"].astype(jnp.bfloat16)
    for max_norm in (0.1, 1e9):
        got, n = topt.clip_by_global_norm(tg, max_norm)
        want, jn = jopt.clip_by_global_norm(jg, max_norm)
        np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
        for k in tree:
            assert str(got[k].dtype) == f"torch.{want[k].dtype}"
            np.testing.assert_allclose(_np(got[k]), _np(want[k]),
                                       rtol=1e-6 if k != "w1" else 8e-3)


@settings(max_examples=30, deadline=None, database=None)
@given(st.integers(0, 2 ** 31 - 1), st.floats(0.01, 100.0))
def test_int8_quantization_bit_for_bit(seed, scale):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(64) * scale).astype(np.float32)
    g[rng.random(64) < 0.1] = 0.0
    q, s = topt.quantize_int8(torch.from_numpy(g))
    jq, js = jopt.quantize_int8(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    back = topt.dequantize_int8(q, s, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jopt.dequantize_int8(jq, js,
                                                      jnp.float32)))
    # the reference's bound: half a quantization bucket
    assert float((back - torch.from_numpy(g)).abs().max()) \
        <= float(s) * 0.5 + 1e-6


def test_int8_compression_tracks_uncompressed():
    """tests/test_train_infra.py: int8 with error feedback tracks the
    uncompressed loss trajectory and keeps the error buffer finite."""
    trajectories, final = {}, None
    for compress in (None, "int8"):
        opt = topt.OptConfig(lr=1e-3, total_steps=30, warmup_steps=1,
                             compress=compress)
        cfg, _, params, _ = setup("mamba2-780m", compute_dtype="float32")
        state = tstep.init_state(params, opt)
        step = tstep.make_train_step(cfg, opt)
        data, losses = DataState(1, 0), []
        for _ in range(10):
            batch, data = next_batch(cfg, 8, 32, data, device="cpu")
            state, metrics = step(state, batch)
            losses.append(float(metrics["ce_loss"]))
        trajectories[compress] = losses
        final = state
    dev = np.max(np.abs(np.asarray(trajectories[None])
                        - np.asarray(trajectories["int8"])))
    assert dev < 0.05, trajectories
    assert all(bool(torch.isfinite(e).all())
               for e in topt.leaves(final["opt"]["err"]))


def test_microbatch_equivalence():
    """tests/test_train_infra.py: k=1 against k=4 accumulation, f32."""
    opt = topt.OptConfig(total_steps=10, warmup_steps=1)
    outs = {}
    for k in (1, 4):
        cfg, _, params, _ = setup("mamba2-780m", microbatches=k,
                                  compute_dtype="float32")
        batch, _ = batch_pair(cfg, b=8)
        state, metrics = tstep.make_train_step(cfg, opt)(
            tstep.init_state(params, opt), batch)
        outs[k] = (float(metrics["ce_loss"]),
                   topt.leaves(state["params"]))
    assert abs(outs[1][0] - outs[4][0]) < 1e-3
    for a, b in zip(outs[1][1], outs[4][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-4)


def test_unused_leaf_decayed_as_reference():
    """hubert-xlarge's ``embed`` takes no part in the encoder's loss: the
    port has no gradient for it, the reference a zero gradient.  One f32
    step each: the embedding is decayed (``p - lr * wd * p``) to the
    reference's values, its moments stay zero, and every other leaf
    agrees within one learning rate."""
    from repro.train import step as jstep
    kw = dict(total_steps=10, warmup_steps=1)
    cfg, jcfg, params, jparams = setup("hubert-xlarge",
                                       compute_dtype="float32")
    batch, jbatch = batch_pair(cfg)
    before = params["embed"].clone()
    state, _ = tstep.make_train_step(cfg, topt.OptConfig(**kw))(
        tstep.init_state(params, topt.OptConfig(**kw)), batch)
    jstate, _ = jax.jit(jstep.make_train_step(jcfg, jopt.OptConfig(**kw)))(
        jstep.init_state(jparams, jopt.OptConfig(**kw)), jbatch)
    emb = state["params"]["embed"]
    assert not torch.equal(emb, before)
    np.testing.assert_allclose(emb.numpy(),
                               np.asarray(jstate["params"]["embed"]),
                               rtol=1e-6, atol=0)
    assert not bool(state["opt"]["m"]["embed"].any())
    assert not bool(state["opt"]["v"]["embed"].any())
    for path in leaf_paths(cfg):
        np.testing.assert_allclose(
            at(state["params"], path).numpy(),
            np.asarray(at(jstate["params"], path)), rtol=0, atol=3e-4,
            err_msg=str(path))
