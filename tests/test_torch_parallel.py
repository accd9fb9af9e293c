"""The port's main path against the JAX package, bit for bit.

``repro_torch.core.api.parallel_skyline(..., device="cpu")`` at the
default config runs on the same numpy inputs as
``repro.core.parallel.parallel_skyline`` with ``impl='perpair'`` (JAX on
the CPU); the configs are carried across by ``repro_torch.convert``.
Compared: every leaf of the result buffer (points through their int32
bits, mask, count, overflow) and the stats ``bucket_counts``,
``bucket_overflow``, ``n_valid``, ``local_sizes``, ``local_overflow`` and
``union_size``.  Tolerance: zero.  The partition step and the sequential
entry points are compared the same way.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import parallel as jpar
from repro.core import partition as jpart
from repro_torch import convert
from repro_torch.core import api as tapi
from repro_torch.core import partition as tpart


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends: each
    keeps memory mappings of its machine code, and a test worker that
    runs several such modules would reach the kernel's map limit
    (vm.max_map_count), where XLA's next compile crashes the worker."""
    yield
    jax.clear_caches()
    gc.collect()


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_buffers_equal(got, want, ctx):
    for g, w, name in zip(convert.buffer_to_numpy(got), want,
                          ("points", "mask", "count", "overflow")):
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{name} differs {ctx}")


def _data(kind, n, d, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        x = rng.random((n, d))
    elif kind == "anticorrelated":
        # points near the plane sum(x) = d/2: large skylines
        jit = rng.random((n, d)) - 0.5
        x = 0.5 + 0.05 * rng.standard_normal((n, 1)) \
            + 0.9 * (jit - jit.mean(axis=1, keepdims=True))
    else:  # tie-heavy: quantised, duplicates, -0.0
        x = rng.integers(0, 4, (n, d)) / 4
        x[rng.random((n, d)) < 0.05] = -0.0
    return np.clip(x, -0.0, 1.0).astype(np.float32), rng.random(n) > 0.1


def _run_both(x, mask, **cfg_kw):
    jcfg = jpar.SkyConfig(impl="perpair", **cfg_kw)
    jbuf, jstats = jpar.parallel_skyline(
        jnp.asarray(x), None if mask is None else jnp.asarray(mask),
        cfg=jcfg)
    tcfg = convert.config_from_reference(
        dict(dataclasses.asdict(jcfg), impl="auto"))
    tbuf, tstats = tapi.parallel_skyline(x, mask, cfg=tcfg, device="cpu")
    _assert_buffers_equal(tbuf, jbuf, str(cfg_kw))
    assert set(tstats) == set(jstats)
    for k in jstats:
        np.testing.assert_array_equal(tstats[k].numpy(),
                                      np.asarray(jstats[k]), err_msg=k)
    return tbuf


@pytest.mark.parametrize("kind", ["uniform", "anticorrelated", "ties"])
@pytest.mark.parametrize("p", [1, 3, 8])
def test_parallel_skyline_matches_jax(kind, p):
    x, mask = _data(kind, 900, 3, seed=p)
    buf = _run_both(x, mask, p=p)
    assert not bool(buf.overflow)


def test_overflow_at_small_capacity():
    x, mask = _data("anticorrelated", 1200, 4, seed=5)
    buf = _run_both(x, mask, capacity=20)
    assert bool(buf.overflow)


@pytest.mark.parametrize("n", [0, 5])
def test_empty_and_tiny_inputs(n):
    x, mask = _data("uniform", n, 3, seed=0)
    _run_both(x, mask)


def test_all_masked_input():
    x, _ = _data("ties", 300, 4, seed=1)
    buf = _run_both(x, np.zeros(300, bool))
    assert int(buf.count) == 0


def test_default_mask_and_d_12():
    x, _ = _data("ties", 400, 12, seed=2)
    _run_both(x, None, p=4, capacity=512)


def test_sliced_part_ids_and_bucketize_match_jax():
    x, mask = _data("ties", 500, 3, seed=3)
    for p in (1, 3, 8):
        want = jpart.sliced_part_ids(jnp.asarray(x), jnp.asarray(mask), p,
                                     dim=1)
        got = tpart.sliced_part_ids(torch.from_numpy(x),
                                    torch.from_numpy(mask), p, dim=1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for cap in (500 // p + 1, 20):      # 20 overflows the buckets
            jb = jpart.bucketize(jnp.asarray(x), jnp.asarray(mask), want, p,
                                 cap)
            tb = tpart.bucketize(torch.from_numpy(x), torch.from_numpy(mask),
                                 got, p, cap)
            for g, w in zip(tb, jb):
                np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


@pytest.mark.parametrize("n,capacity", [(700, None), (700, 16), (0, None)])
def test_skyline_matches_jax(n, capacity):
    x, mask = _data("ties", n, 4, seed=n)
    want = japi.skyline(jnp.asarray(x), jnp.asarray(mask), capacity=capacity,
                        block=64, impl="perpair")
    got = tapi.skyline(x, mask, capacity=capacity, block=64, device="cpu")
    _assert_buffers_equal(got, want, f"n={n} capacity={capacity}")


def test_skyline_mask_exact_matches_jax():
    x, mask = _data("ties", 500, 3, seed=8)
    want = japi.skyline_mask_exact(jnp.asarray(x), jnp.asarray(mask))
    got = tapi.skyline_mask_exact(x, mask, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def feed_reference_random_ids(monkeypatch, keys):
    """Make the port's random strategy take the reference's ids: the
    i-th call of ``random_part_ids`` returns
    ``repro.core.partition.random_part_ids(keys[i], n, p)``
    (ROADMAP.md, contract 5).  Returns the list of keys not yet used."""
    left = list(keys)

    def ids(generator, n, p, *, device=None):
        return torch.from_numpy(np.array(
            jpart.random_part_ids(left.pop(0), n, p))).to(device)

    monkeypatch.setattr(tpart, "random_part_ids", ids)
    return left


STRATEGY_OPTS = {"sequential": {}, "noseq": dict(noseq=True),
                 "sorted": dict(rep_filter="sorted")}


@pytest.mark.parametrize("merge", ["flat", "tree"])
@pytest.mark.parametrize("opt", list(STRATEGY_OPTS))
@pytest.mark.parametrize("strategy", ["random", "grid", "angular", "sliced"])
def test_strategies_match_jax(strategy, opt, merge, monkeypatch):
    """Every strategy through parallel_skyline: every leaf and stat; the
    random strategy given the reference's ids.  Without overflow the
    buffer is the default configuration's answer."""
    import jax
    x, mask = _data("anticorrelated", 800, 3, seed=11)
    left = feed_reference_random_ids(monkeypatch, [jax.random.PRNGKey(0)])
    buf = _run_both(x, mask, strategy=strategy, p=8, bucket_factor=3.0,
                    rep_k=8, merge=merge, **STRATEGY_OPTS[opt])
    assert len(left) == (strategy != "random")
    assert not bool(buf.overflow)
    plain, _ = tapi.parallel_skyline(x, mask, device="cpu")
    _assert_buffers_equal(buf, convert.buffer_to_numpy(plain), "default")


@pytest.mark.parametrize("strategy", ["grid", "angular"])
def test_strategies_overflow_like_jax(strategy):
    """Skewed buckets at the default factor drop rows in both packages
    alike (bucket_overflow set, the same truncated answer)."""
    x, mask = _data("uniform", 900, 4, seed=12)
    x[:300] *= np.float32(0.1)          # a crowded corner cell
    buf = _run_both(x, mask, strategy=strategy, m=2, grid_filter=False)
    assert bool(buf.overflow)


def test_random_strategy_draws_from_the_generator():
    x, _ = _data("uniform", 400, 3, seed=13)
    cfg = tapi.SkyConfig(strategy="random", p=4)
    a, sa = tapi.parallel_skyline(x, cfg=cfg, device="cpu",
                                  generator=torch.Generator().manual_seed(5))
    b, sb = tapi.parallel_skyline(x, cfg=cfg, device="cpu")
    for g, w in zip(a, b):           # the buffer does not depend on the draw
        assert torch.equal(g, w)
    assert sa["bucket_counts"].tolist() == [100] * 4
    plain, _ = tapi.parallel_skyline(x, device="cpu")
    for g, w in zip(a, plain):
        assert torch.equal(g, w)
