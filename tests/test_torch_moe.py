"""The port's mixture-of-experts layer (`repro_torch.models.moe`) against
``repro.models.moe`` on the CPU.

* Exactly: the dispatch (each choice's destination row, whether it was
  kept, and the (E, cap, D) buffer's bits) given the same routing
  choices and tokens, the reference's taken from its own ``moe_apply``
  (its ``jax.lax.top_k`` returns the given choices; its buffer and
  destinations are read where its expert products and its combine
  receive them); and the routing order against ``jax.lax.top_k`` over
  ties.
* f32 compute, rtol = atol = 1e-4: ``moe_apply``'s output and aux terms
  without drops, and with drops where the router's top-k margin is
  large (router weights scaled up), with and without a shared expert.
* bf16 compute: the whole mixtral and llama4 smoke models, as
  ``tests/test_torch_transformer.py`` holds the other eight
  (`_torch_models.check_bf16_against_reference`: the reference's routing
  replayed in the port, norm-wise within bf16's own error).
"""

import _torch_threads  # noqa: F401  (one torch thread)
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import (F32_TOL, assert_bits, assert_close,
                           check_bf16_against_reference)
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.core.dominance import topk_order
from repro_torch.models import moe as tmoe
from repro_torch.models.common import init_params


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends (memory
    mappings; see ``tests/test_torch_scheduler.py``)."""
    yield
    jax.clear_caches()
    gc.collect()


class _Capture:
    """Stands in for ``jax.numpy`` inside ``repro.models.moe``: records
    the dispatch buffer the expert products receive and the
    destinations the combine gathers from."""

    def __init__(self):
        self.buf, self.dest = [], []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        if spec == "ecd,edf->ecf" and not self.buf:
            self.buf.append(np.asarray(ops[0]))
        return jnp.einsum(spec, *ops, **kw)

    def take(self, a, idx, **kw):
        self.dest.append(np.asarray(idx))
        return jnp.take(a, idx, **kw)


def _layer(d, f, e, shared, seed):
    plan = tmoe.moe_plan(d, f, e, shared)
    params = init_params(plan, seed=seed, device="cpu")
    return params, jax.tree.map(jnp.asarray, convert.params_to_numpy(params))


@pytest.mark.parametrize("top_k,cf,skew,dt", [
    (2, 4.0, False, "float32"),     # drop-free
    (2, 1.0, True, "float32"),      # skewed choices: drops
    (1, 1.25, True, "bfloat16"),
    (2, 0.5, False, "bfloat16"),    # capacity below one slot a choice
])
def test_dispatch_is_exact(top_k, cf, skew, dt, monkeypatch):
    e, d, b, s = 4, 8, 2, 9
    rng = np.random.default_rng(top_k * 10 + int(skew))
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    p = [0.7, 0.1, 0.1, 0.1] if skew else None
    choice = np.stack([rng.choice(e, top_k, replace=False, p=p)
                       for _ in range(b * s)]).astype(np.int32)
    _, jparams = _layer(d, 16, e, False, seed=1)

    def top_k_given(probs, k):
        idx = jnp.asarray(choice)
        return jnp.take_along_axis(probs, idx, axis=-1), idx

    cap = _Capture()
    monkeypatch.setattr(jax.lax, "top_k", top_k_given)
    monkeypatch.setattr(jmoe, "jnp", cap)
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    with jax.disable_jit():
        jmoe.moe_apply(jparams, jnp.asarray(x), n_experts=e, top_k=top_k,
                       capacity_factor=cf, compute_dtype=jdt)
    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    buf, dest, ok = tmoe.moe_dispatch(
        torch.from_numpy(x.reshape(b * s, d)),
        torch.from_numpy(choice.reshape(-1)).long(), n_experts=e,
        top_k=top_k, capacity_factor=cf, compute_dtype=tdt)
    n_cap = tmoe.moe_capacity(b * s, top_k, e, cf)
    assert n_cap == max(1, int(cf * b * s * top_k / e))
    assert tuple(buf.shape) == cap.buf[0].shape == (e, n_cap, d)
    assert buf.dtype == tdt
    assert_bits(buf.view(torch.int16) if dt == "bfloat16" else buf,
                cap.buf[0].view(np.int16) if dt == "bfloat16"
                else cap.buf[0])
    np.testing.assert_array_equal(dest.numpy(), cap.dest[0])
    np.testing.assert_array_equal(ok.numpy(), cap.dest[0] < e * n_cap)
    assert bool((~ok).any()) == (skew or cf < 1)


def test_routing_order_is_lax_top_k():
    """Descending, ``+0.0`` above ``-0.0``, the lower expert first among
    ties."""
    probs = np.array([[0.25, 0.25, 0.5, 0.0], [0.1, 0.3, 0.3, 0.3],
                      [0.0, -0.0, 0.0, 1.0], [0.25] * 4], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(probs), 3)
    got = topk_order(torch.from_numpy(probs))[:, :3]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cf,router_scale,shared", [
    (4.0, 1.0, False),          # drop-free
    (4.0, 1.0, True),
    (1.0, 30.0, False),         # drops, decisive router
    (1.0, 30.0, True),
])
def test_moe_apply_f32(cf, router_scale, shared):
    e, d, f, k = 4, 16, 32, 2
    params, jparams = _layer(d, f, e, shared, seed=2)
    params["router"] = params["router"] * router_scale
    jparams["router"] = jparams["router"] * router_scale
    x = np.random.default_rng(3).standard_normal((3, 10, d)).astype(
        np.float32)
    got, aux = tmoe.moe_apply(params, torch.from_numpy(x), n_experts=e,
                              top_k=k, capacity_factor=cf,
                              compute_dtype=torch.float32)
    want, jaux = jax.jit(lambda p, v: jmoe.moe_apply(
        p, v, n_experts=e, top_k=k, capacity_factor=cf,
        compute_dtype=jnp.float32))(jparams, jnp.asarray(x))
    assert_close(got, want, F32_TOL, "output")
    assert set(aux) == set(jaux) == {"moe_aux_loss", "moe_drop_frac"}
    for key in jaux:
        assert_close(aux[key], jaux[key], F32_TOL, key)
    assert (float(aux["moe_drop_frac"]) > 0) == (cf < 2)


@pytest.mark.parametrize("arch", ["mixtral-8x7b",
                                  "llama4-maverick-400b-a17b"])
def test_bf16_moe_models_match_reference(arch, monkeypatch):
    check_bf16_against_reference(arch, monkeypatch)
