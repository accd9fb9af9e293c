"""Shared helpers of the training parity tests
(``tests/test_torch_{optim,train_step,train_loop}.py``).

Both packages get the same parameters (the port's CPU ``init_params``
from a seed) and the same batches (``data.pipeline.make_batch``, bit
for bit the same in both).  Every array handed to JAX is a copy: the
port's train step writes its tensors in place, and ``jnp.asarray`` of a
host array may alias it while JAX still reads it asynchronously.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import configs, np32, op_by_op, record_routing
from repro_torch import convert
from repro_torch.data.pipeline import DataState, make_batch
from repro_torch.models import transformer as TT
from repro_torch.models.common import init_params, plan_leaves

B, S = 4, 32     # the reference's smoke batch (tests/test_models_smoke.py)


def jax_copy(tree):
    """A tree of tensors or arrays as JAX arrays that own their memory."""
    return jax.tree.map(lambda a: jnp.asarray(np.array(a, copy=True)),
                        convert.params_to_numpy(tree))


def setup(arch, *, seed=0, **kw):
    """(port config, reference config, port params, reference params):
    smoke-sized, ``kw`` replaced in both configs."""
    cfg, jcfg = configs(arch, **kw)
    params = init_params(TT.lm_plan(cfg), seed=seed, device="cpu")
    return cfg, jcfg, params, jax_copy(params)


def batch_pair(cfg, b=B, s=S, seed=0):
    """(port batch, reference batch) at the data cursor (seed, 0)."""
    tb = make_batch(cfg, b, s, DataState(seed, 0), device="cpu")
    return tb, {k: jnp.asarray(np.array(v.numpy(), copy=True))
                for k, v in tb.items()}


def leaf_paths(cfg):
    return [path for path, _ in plan_leaves(TT.lm_plan(cfg))]


def at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def f32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


def reference_grads(jcfg, jparams, jbatch, compile_fn=None):
    """(loss, grads) of the reference's ``loss_fn``, jitted (or compiled
    by ``compile_fn``, such as ``_torch_models.op_by_op``)."""
    from repro.models import transformer as JT
    fn = jax.value_and_grad(lambda p, b: JT.loss_fn(p, jcfg, b)[0])
    if compile_fn is not None:
        return compile_fn(fn, jparams, jbatch)
    return jax.jit(fn)(jparams, jbatch)


def _unrolled_scan(fn, init, xs, cfg):
    """The reference's layer scan as a Python loop (traced layer by
    layer)."""
    del cfg
    n = jax.tree.leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in range(n):
        carry, y = fn(carry, jax.tree.map(lambda a: a[i], xs))
        ys.append(y)
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


def reference_grads_on_routing(jcfg, jparams, jbatch, recorded):
    """(loss, grads) of the reference's ``loss_fn``, jitted, with its MoE
    layers taking the ``recorded`` top-k choices in order: its layer
    scan unrolled, so each layer's ``top_k`` is traced on its own and
    takes the next choice as a constant.  (Under ``value_and_grad`` a
    jitted scan ran `_torch_models.force_routing`'s ``io_callback`` once
    for two layers.)"""
    from repro.models import transformer as JT
    queue = list(recorded)

    def top_k(x, k):
        idx = jnp.asarray(queue.pop(0).astype(np.int32))
        assert idx.shape == x.shape[:-1] + (k,)
        return jnp.take_along_axis(x, idx, axis=-1), idx

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "top_k", top_k)
        mp.setattr(JT, "_scan", _unrolled_scan)
        out = reference_grads(jcfg, jparams, jbatch)
    assert queue == [], f"{len(queue)} routing choices left over"
    return out


_REFERENCE = {}


def reference_gradients(arch) -> dict:
    """The reference's gradients on the shared smoke parameters and
    batch (``remat=False``), computed once per arch: ``bf16`` compiled
    without excess precision (`_torch_models.op_by_op`), ``f32`` (and
    ``f32_loss``) in f32 compute; for an MoE config the routing of the
    bf16 run (``routing``), which the f32 run takes too.  Leaves as
    numpy."""
    if arch in _REFERENCE:
        return _REFERENCE[arch]
    from repro.models import transformer as JT
    cfg, jcfg, _, jparams = setup(arch, remat=False)
    _, jbatch = batch_pair(cfg)
    vg = lambda c: jax.value_and_grad(lambda p, b: JT.loss_fn(p, c, b)[0])
    if cfg.n_experts:
        recorded = []
        with pytest.MonkeyPatch.context() as mp:
            recorded = record_routing(mp)
            _, bf16 = op_by_op(vg(jcfg), jparams, jbatch)
            jax.effects_barrier()
        loss, g32 = reference_grads_on_routing(f32(jcfg), jparams, jbatch,
                                               recorded)
    else:
        recorded = None
        (_, bf16), (loss, g32) = op_by_op(
            lambda p, b: (vg(jcfg)(p, b), vg(f32(jcfg))(p, b)), jparams,
            jbatch)
    out = {"bf16": jax.tree.map(np32, bf16), "f32": jax.tree.map(np32, g32),
           "f32_loss": float(loss), "routing": recorded}
    _REFERENCE[arch] = out
    return out


def clear_reference_gradients():
    _REFERENCE.clear()


def port_grads(cfg, params, batch):
    """(loss, grads) of the port, unused leaves as zeros."""
    from repro_torch.train.step import loss_and_grads
    loss, _, grads = loss_and_grads(params, cfg, batch)
    grads = TT.tree_map(lambda g, p: torch.zeros_like(p) if g is None
                        else g, grads, params)
    return loss, grads


def norm(x):
    return float(np.linalg.norm(np32(x).ravel()))


def dist(a, b):
    return float(np.linalg.norm(np32(a).ravel() - np32(b).ravel()))


def state_bits(tree):
    """Every leaf of a state as (dtype name, raw bytes), in order."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for x in t:
                walk(x)
        else:
            a = t.detach().cpu()
            raw = a.contiguous().reshape(-1).view(torch.uint8)
            out.append((str(a.dtype), tuple(a.shape), raw.numpy().tobytes()))

    walk(tree)
    return out


def _port_on_routing(cfg, params, batch, routing, monkeypatch):
    """The port's (loss, grads), replaying ``routing`` when given."""
    from _torch_models import replay_routing
    if routing is None:
        return port_grads(cfg, params, batch)
    queue = replay_routing(monkeypatch, routing)
    out = port_grads(cfg, params, batch)
    assert queue == []
    return out


def check_f32_gradients(arch, monkeypatch):
    """f32 compute: the loss within 1e-5 relative and every leaf's
    gradient norm-wise within 2e-3 of the reference's."""
    cfg, _, params, _ = setup(arch, remat=False)
    batch, _ = batch_pair(cfg)
    ref = reference_gradients(arch)
    loss, grads = _port_on_routing(f32(cfg), params, batch, ref["routing"],
                                   monkeypatch)
    want_loss = ref["f32_loss"]
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss), (
        float(loss), want_loss)
    for path in leaf_paths(cfg):
        g, w = at(grads, path), at(ref["f32"], path)
        assert tuple(g.shape) == w.shape, path
        assert dist(g, w) <= 2e-3 * norm(w), (path, dist(g, w), norm(w))


def check_bf16_gradients(arch, monkeypatch):
    """bf16 compute: every leaf's |port - reference| at most
    max(|reference bf16 - reference f32|, 1e-3 |reference f32|)."""
    cfg, _, params, _ = setup(arch, remat=False)
    assert cfg.compute_dtype == "bfloat16"
    batch, _ = batch_pair(cfg)
    ref = reference_gradients(arch)
    _, got = _port_on_routing(cfg, params, batch, ref["routing"],
                              monkeypatch)
    for path in leaf_paths(cfg):
        g, w, w32 = at(got, path), at(ref["bf16"], path), at(ref["f32"],
                                                             path)
        bound = max(dist(w, w32), 1e-3 * norm(w32))
        assert np.isfinite(np32(g)).all(), path
        assert dist(g, w) <= bound, (
            f"{arch} {'/'.join(path)}: |port - reference| = {dist(g, w)} > "
            f"max(|reference bf16 - f32|, 1e-3 |f32|) = {bound}")


def one_torch_thread():
    """Run a module's torch work on one thread, then restore the count:
    the smoke models' operations are tiny, and beside pytest-xdist's
    other workers torch's thread pool costs more than it gives (the
    step tests ran about twice as fast on one thread as on eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    return lambda: torch.set_num_threads(n)
