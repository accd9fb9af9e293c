"""The port's Mamba-2 block (`repro_torch.models.ssm`) against
``repro.models.ssm`` on the CPU.

* Exactly: ``_segsum``'s ``-inf`` pattern above the diagonal, and the
  state's structure (``init_ssm_state``).
* f32 compute, rtol = atol = 1e-4: ``_segsum``'s values, the causal conv
  (sequences shorter and longer than its width), the chunked SSD scan,
  ``mamba2_apply`` with and without padding to a chunk multiple (output
  and the final state, conv tails included) and ``mamba2_decode`` from
  a given state.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import F32_TOL, assert_close
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.models import ssm as tssm
from repro_torch.models.common import init_params

H, P, N, D = 4, 8, 6, 16


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends (memory
    mappings; see ``tests/test_torch_scheduler.py``)."""
    yield
    jax.clear_caches()
    gc.collect()


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _params(seed):
    params = init_params(tssm.mamba2_plan(D, H, P, N), seed=seed,
                         device="cpu")
    # non-trivial decay, bias, skip and norm
    params["A_log"] = torch.from_numpy(_rand((H,), seed + 1, 0.5))
    params["dt_bias"] = torch.from_numpy(_rand((H,), seed + 2, 0.5))
    params["D"] = torch.from_numpy(_rand((H,), seed + 3))
    params["norm"] = torch.from_numpy(_rand((H, P), seed + 4, 0.1))
    return params, jax.tree.map(jnp.asarray, convert.params_to_numpy(params))


def test_segsum():
    x = _rand((2, 3, 7), 0, 0.3)
    got = tssm._segsum(torch.from_numpy(x)).numpy()
    want = np.asarray(jssm._segsum(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got).sum() == 2 * 3 * 21
    finite = np.isfinite(want)
    assert_close(got[finite], want[finite], F32_TOL)


@pytest.mark.parametrize("s", [2, 9])
def test_causal_conv(s):
    x, kern = _rand((2, s, H, P), 1), _rand((4, H, P), 2)
    got = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(kern))
    want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(kern))
    assert_close(got, want, F32_TOL)


def test_ssd_scan():
    xdt, dta = _rand((2, 12, H, P), 3, 0.5), -np.abs(_rand((2, 12, H), 4,
                                                           0.3))
    b_in, c_in = _rand((2, 12, N), 5), _rand((2, 12, N), 6)
    y, h = tssm._ssd_scan(*(torch.from_numpy(a) for a in
                            (xdt, dta, b_in, c_in)), 4)
    jy, jh = jssm._ssd_scan(*(jnp.asarray(a) for a in
                              (xdt, dta, b_in, c_in)), 4)
    assert_close(y, jy, F32_TOL, "y")
    assert_close(h, jh, F32_TOL, "final state")


@pytest.mark.parametrize("s,chunk", [(16, 8), (13, 8), (3, 8)])
def test_mamba2_apply(s, chunk):
    params, jparams = _params(7)
    x = _rand((2, s, D), 8)
    kw = dict(n_heads=H, head_dim=P, state=N, chunk=chunk)
    y, st = tssm.mamba2_apply(params, torch.from_numpy(x),
                              compute_dtype=torch.float32, **kw)
    jy, jst = jax.jit(lambda p, v: jssm.mamba2_apply(
        p, v, compute_dtype=jnp.float32, **kw))(jparams, jnp.asarray(x))
    assert_close(y, jy, F32_TOL, "output")
    assert isinstance(st, tssm.SSMState)
    for name in tssm.SSMState._fields:
        assert_close(getattr(st, name), getattr(jst, name), F32_TOL, name)


def test_mamba2_decode():
    params, jparams = _params(9)
    st = tssm.SSMState(torch.from_numpy(_rand((2, H, P, N), 10)),
                       torch.from_numpy(_rand((2, 3, H, P), 11)),
                       torch.from_numpy(_rand((2, 3, N), 12)),
                       torch.from_numpy(_rand((2, 3, N), 13)))
    x = _rand((2, 1, D), 14)
    kw = dict(n_heads=H, head_dim=P, state=N)
    y, new = tssm.mamba2_decode(params, torch.from_numpy(x), st,
                                compute_dtype=torch.float32, **kw)
    jst = jssm.SSMState(*(jnp.asarray(a.numpy()) for a in st))
    jy, jnew = jax.jit(lambda p, v, c: jssm.mamba2_decode(
        p, v, c, compute_dtype=jnp.float32, **kw))(jparams, jnp.asarray(x),
                                                   jst)
    assert_close(y, jy, F32_TOL, "output")
    for name in tssm.SSMState._fields:
        assert_close(getattr(new, name), getattr(jnew, name), F32_TOL, name)


def test_init_ssm_state_structure():
    got = tssm.init_ssm_state(2, H, P, N, dtype=torch.bfloat16,
                              device="cpu")
    want = jssm.init_ssm_state(2, H, P, N, dtype=jnp.bfloat16)
    assert tssm.SSMState._fields == jssm.SSMState._fields
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape and str(a.dtype) == f"torch.{b.dtype}"
        assert not bool(a.float().abs().sum())
