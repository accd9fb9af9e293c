"""The port's partition-id maps and routing against the JAX package.

``repro_torch.core.partition``'s grid and angular ids, grid cell
coordinates and ``bucketize`` run on the same numpy inputs as their
counterparts in ``repro.core.partition`` (JAX on the CPU, under ``jit``
as the reference's pipeline runs them).  Tolerance: zero; ids, cells,
masks and counts must be equal element for element, points through
their int32 bits.  The random strategy draws from ``jax.random`` there
and from a ``torch.Generator`` here (ROADMAP.md, contract 5): its ids
are held to their balance, and ``bucketize`` is held against the
reference given the reference's ids.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition as jpart
from repro_torch.core import partition as tpart

DIMS = [1, 2, 3, 4, 5, 6, 7, 8, 12]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@functools.cache
def _jitted(name):
    return jax.jit(getattr(jpart, name), static_argnums=1)


def _data(d, kind, n=600):
    """Uniform data, or data quantised to eighths with +-0.0 (rows on
    the cells' and the angles' boundaries)."""
    rng = np.random.default_rng(d * 10 + (kind == "eighths"))
    x = rng.random((n, d)).astype(np.float32)
    if kind == "eighths":
        x = (np.floor(x * 8) / 8).astype(np.float32)
        x[rng.random((n, d)) < 0.05] = -0.0
        x[rng.random((n, d)) < 0.02] = 0.0
    return x


@pytest.mark.parametrize("kind", ["uniform", "eighths"])
@pytest.mark.parametrize("d", DIMS)
def test_grid_and_angular_ids_match_jax(d, kind):
    x = _data(d, kind)
    tx = torch.from_numpy(x)
    for m in (1, 2, 3, 4):
        if m ** d > 2 ** 24:
            continue
        for name in ("grid_cell_coords", "grid_part_ids", "angular_part_ids"):
            want = np.asarray(_jitted(name)(jnp.asarray(x), m))
            got = getattr(tpart, name)(tx, m)
            assert got.dtype == torch.int32, name
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{name} m={m}")


def test_ids_of_values_outside_the_unit_cube():
    """Negative values, values above 1 and the sentinel clip to the
    outer cells, as in the reference."""
    x = np.array([[-0.5, 1.5, 0.25], [1.7e38, -0.0, 1.0],
                  [0.999, 0.0, -1e-3]], np.float32)
    for m in (2, 3):
        for name in ("grid_cell_coords", "grid_part_ids", "angular_part_ids"):
            np.testing.assert_array_equal(
                getattr(tpart, name)(torch.from_numpy(x), m).numpy(),
                np.asarray(_jitted(name)(jnp.asarray(x), m)), err_msg=name)


@pytest.mark.parametrize("n,p", [(0, 3), (1, 4), (10, 4), (97, 8), (64, 8)])
def test_random_ids_are_balanced(n, p):
    gen = torch.Generator().manual_seed(n)
    ids = tpart.random_part_ids(gen, n, p)
    assert ids.dtype == torch.int32 and ids.shape == (n,)
    counts = torch.bincount(ids.long(), minlength=p)
    want = np.bincount(np.arange(n) % p, minlength=p)
    np.testing.assert_array_equal(counts.numpy(), want)
    again = tpart.random_part_ids(torch.Generator().manual_seed(n), n, p)
    assert torch.equal(ids, again)


@pytest.mark.parametrize("p,cap", [(4, 200), (4, 30), (8, 1)])
def test_bucketize_with_the_reference_random_ids(p, cap):
    rng = np.random.default_rng(p + cap)
    x = (rng.integers(0, 4, (500, 3)) / 4).astype(np.float32)
    x[rng.random((500, 3)) < 0.05] = -0.0
    mask = rng.random(500) > 0.1
    ids = jpart.random_part_ids(jax.random.PRNGKey(cap), 500, p)
    want = jpart.bucketize(jnp.asarray(x), jnp.asarray(mask), ids, p, cap)
    got = tpart.bucketize(torch.from_numpy(x), torch.from_numpy(mask),
                          torch.from_numpy(np.array(ids)), p, cap)
    for g, w, name in zip(got, want, tpart.Buckets._fields):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w),
                                      err_msg=name)


@pytest.mark.parametrize("strategy", ["grid", "angular"])
def test_bucketize_with_grid_and_angular_ids(strategy):
    x = _data(4, "eighths", n=800)
    mask = np.random.default_rng(1).random(800) > 0.1
    name = f"{strategy}_part_ids"
    p = 16 if strategy == "grid" else 8
    ids_j = _jitted(name)(jnp.asarray(x), 2)
    ids_t = getattr(tpart, name)(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    for cap in (800, 40):
        want = jpart.bucketize(jnp.asarray(x), jnp.asarray(mask), ids_j, p,
                               cap)
        got = tpart.bucketize(torch.from_numpy(x), torch.from_numpy(mask),
                              ids_t, p, cap)
        for g, w, field in zip(got, want, tpart.Buckets._fields):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w),
                                          err_msg=f"{field} cap={cap}")
