"""The port's ordering primitives against the JAX package, bit for bit.

``monotone_score``, ``canonical_order`` and the dominance oracle of
``repro_torch`` are run on the same numpy inputs as their counterparts in
``repro`` (JAX on the CPU).  Tolerance: zero.  f32 results are compared
through their int32 bits, so ``-0.0`` against ``+0.0`` is a failure;
permutations and masks must be equal element for element.

Subnormal inputs are held in tests/test_torch_subnormal.py: the port
flushes them in comparisons and arithmetic as XLA on the CPU does.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dominance as jdom
from repro.kernels.dominance import ref as jref
from repro_torch.core import dominance as tdom
from repro_torch.kernels.dominance import ref as tref


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _tie_heavy(rng, n, d, levels=4):
    """Quantised coordinates (ties and duplicates), some -0.0."""
    x = (rng.integers(0, levels, (n, d)) / levels).astype(np.float32)
    x[rng.random((n, d)) < 0.1] = -0.0
    return x


@pytest.mark.parametrize("d", range(1, 13))
def test_monotone_score_bits_match_jax(d):
    rng = np.random.default_rng(100 + d)
    n = 4000
    x = (rng.random((n, d)) * rng.choice([1e-3, 1.0, 1e3], (n, d))).astype(
        np.float32)
    x[rng.random((n, d)) < 0.05] = -0.0
    x[:20] = -0.0                               # all-(-0.0) rows
    x[20:40] = np.float32(tdom.SENTINEL)        # sentinel rows (overflow)
    mask = rng.random(n) > 0.2
    for shape in ((n, d), (4, n // 4, d)):
        xs, ms = x.reshape(shape), mask.reshape(shape[:-1])
        for m in (None, ms):
            want = jdom.monotone_score(jnp.asarray(xs),
                                       None if m is None else jnp.asarray(m))
            got = tdom.monotone_score(torch.from_numpy(xs),
                                      None if m is None else
                                      torch.from_numpy(m))
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want),
                                          err_msg=f"d={d} shape={shape}")


@pytest.mark.parametrize("d,levels", [(2, 3), (4, 4), (7, 2), (12, 3)])
def test_canonical_order_matches_jax(d, levels):
    rng = np.random.default_rng(7 * d + levels)
    x = _tie_heavy(rng, 600, d, levels)
    x[300:400] = x[:100]                        # exact duplicates
    mask = rng.random(600) > 0.15
    for m in (None, mask):
        want = jdom.canonical_order(jnp.asarray(x),
                                    None if m is None else jnp.asarray(m))
        got = tdom.canonical_order(torch.from_numpy(x),
                                   None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stable_argsort_treats_signed_zeros_as_equal():
    v = torch.tensor([0.0, -0.0, 1.0, -0.0, 0.0, -1.0])
    assert tdom.stable_argsort(v).tolist() == [5, 0, 1, 3, 4, 2]
    assert torch.signbit(tdom.sort_key(v)).tolist() == [False] * 5 + [True]


def test_apply_sentinel_keeps_valid_bits():
    x = torch.tensor([[-0.0, 1.0], [2.0, 3.0]])
    out = tdom.apply_sentinel(x, torch.tensor([True, False]))
    want = jdom.apply_sentinel(jnp.asarray(x.numpy()),
                               jnp.asarray([True, False]))
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(want))


@pytest.mark.parametrize("lower_tri", [False, True])
def test_dominated_mask_ref_matches_jax(lower_tri):
    rng = np.random.default_rng(11 + lower_tri)
    cands = _tie_heavy(rng, 150, 3)
    refs = cands if lower_tri else _tie_heavy(rng, 90, 3)
    rmask = rng.random(refs.shape[0]) > 0.3
    want = jref.dominated_mask_ref(jnp.asarray(cands), jnp.asarray(refs),
                                   jnp.asarray(rmask), lower_tri=lower_tri)
    got = tref.dominated_mask_ref(torch.from_numpy(cands),
                                  torch.from_numpy(refs),
                                  torch.from_numpy(rmask),
                                  lower_tri=lower_tri)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tref.dominance_matrix_ref(torch.from_numpy(refs),
                                  torch.from_numpy(cands)).numpy(),
        np.asarray(jref.dominance_matrix_ref(jnp.asarray(refs),
                                             jnp.asarray(cands))))


def test_dominates_predicate():
    t = torch.tensor([0.1, 0.2])
    assert bool(tdom.dominates(t, torch.tensor([0.1, 0.3])))
    assert not bool(tdom.dominates(t, t))
    assert not bool(tdom.dominates(t, torch.tensor([0.0, 0.3])))
