"""Representative Filtering (paper §4.1) and NoSeq (§4.2) of the port
against the JAX package, bit for bit.

The port's ``select_representatives``, ``filter_by_representatives``,
``region_volume``, ``pd_row_mask`` and ``relative_skyline_mask``, and
``parallel_skyline`` with ``rep_filter`` and with ``noseq=True``, run on
the same numpy inputs as their counterparts in ``repro`` (JAX on the
CPU, ``impl='perpair'``, whose dominance tests are ``'jnp'``).
Tolerance: zero.  f32 results are compared through their int32 bits, so
``-0.0`` against ``+0.0`` is a failure.  ``rep_filter='random'`` draws
different numbers in the two packages, so only its final buffer, which
does not depend on the draw, is compared (ROADMAP.md, contract 5).
"""

import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import dominance as jdom
from repro.core import filtering as jfilt
from repro.core import noseq as jnoseq
from repro.core import parallel as jpar
from repro_torch import convert
from repro_torch.core import api as tapi
from repro_torch.core import dominance as tdom
from repro_torch.core import filtering as tfilt
from repro_torch.core import noseq as tnoseq


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


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want),
                                  err_msg=msg)


def _tie_heavy(rng, n, d, levels=4, zero_rows=0):
    """Quantised coordinates (ties and duplicates), some -0.0, and
    ``zero_rows`` rows of all zeros (both signs)."""
    x = (rng.integers(0, levels, (n, d)) / levels).astype(np.float32)
    x[rng.random((n, d)) < 0.1] = -0.0
    x[:zero_rows] = 0.0
    x[:zero_rows:2] = -0.0
    rng.shuffle(x)
    return x


def _anticorrelated(rng, n, d):
    jit = rng.random((n, d)) - 0.5
    x = 0.5 + 0.05 * rng.standard_normal((n, 1)) \
        + 0.9 * (jit - jit.mean(axis=1, keepdims=True))
    return np.clip(x, 0.0, 1.0).astype(np.float32)


def test_topk_order_signed_zeros_and_ties():
    """jax.lax.top_k puts +0.0 above -0.0 and the lower index first among
    equal values; torch.topk and a stable descending float sort do not."""
    v = np.array([-0.0, 0.0, -0.0, 0.0, 1, 1, -np.inf, -np.inf], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(v), 6)
    np.testing.assert_array_equal(np.asarray(want), [4, 5, 1, 3, 0, 2])
    got = tdom.topk_order(torch.from_numpy(v))[:6]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(0)
    m = rng.choice(np.array([-0.0, 0.0, -1.0, 0.5, -np.inf], np.float32),
                   (5, 300))
    _, want = jax.lax.top_k(jnp.asarray(m), 300)
    np.testing.assert_array_equal(
        tdom.topk_order(torch.from_numpy(m)).numpy(), np.asarray(want))


@pytest.mark.parametrize("d", range(1, 13))
def test_region_volume_bits_match_jax(d):
    rng = np.random.default_rng(30 + d)
    x = (rng.random((3000, d)) * 1.4 - 0.2).astype(np.float32)
    x[rng.random((3000, d)) < 0.05] = -0.0
    _eq(tdom.region_volume(torch.from_numpy(x)),
        np.asarray(jdom.region_volume(jnp.asarray(x))), f"d={d}")


@pytest.mark.parametrize("strategy", ["sorted", "region"])
@pytest.mark.parametrize("k", [1, 4, 16, 500])
def test_select_representatives_matches_jax(strategy, k):
    """Tie-heavy data with all-zero rows: the 'sorted' merit of such a
    row is -0.0, so the pick depends on top_k's signed-zero order."""
    rng = np.random.default_rng(k)
    x = _tie_heavy(rng, 300, 3, zero_rows=12)
    mask = rng.random(300) > 0.2
    jr, jm = jfilt.select_representatives(jnp.asarray(x), jnp.asarray(mask),
                                          k, strategy=strategy, impl="jnp")
    tr, tm = tfilt.select_representatives(
        torch.from_numpy(x), torch.from_numpy(mask), k, strategy=strategy,
        impl="torch")
    _eq(tr, np.asarray(jr), "reps")
    _eq(tm, np.asarray(jm), "repmask")


@pytest.mark.parametrize("strategy", ["sorted", "region"])
def test_select_representatives_batched_and_sparse(strategy):
    """A leading partition axis equals per-partition calls, down to
    partitions with fewer valid rows than k, or none."""
    rng = np.random.default_rng(2)
    x = _tie_heavy(rng, 4 * 60, 4, zero_rows=20).reshape(4, 60, 4)
    mask = rng.random((4, 60)) > 0.3
    mask[1, 3:] = False
    mask[2] = False
    tr, tm = tfilt.select_representatives(
        torch.from_numpy(x), torch.from_numpy(mask), 8, strategy=strategy,
        impl="torch")
    for i in range(4):
        jr, jm = jfilt.select_representatives(
            jnp.asarray(x[i]), jnp.asarray(mask[i]), 8, strategy=strategy,
            impl="jnp")
        _eq(tr[i], np.asarray(jr), f"reps {i}")
        _eq(tm[i], np.asarray(jm), f"repmask {i}")


def test_random_representatives_need_a_generator():
    x = torch.rand(20, 3)
    m = torch.ones(20, dtype=torch.bool)
    with pytest.raises(ValueError, match="Generator"):
        tfilt.select_representatives(x, m, 4, strategy="random")
    reps, rmask = tfilt.select_representatives(
        x, m, 4, strategy="random", generator=torch.Generator().manual_seed(1))
    assert reps.shape == (4, 3) and bool(rmask.any())
    with pytest.raises(ValueError, match="unknown representative"):
        tfilt.select_representatives(x, m, 4, strategy="nope")


def test_filter_by_representatives_matches_jax():
    rng = np.random.default_rng(3)
    x = _tie_heavy(rng, 400, 4, zero_rows=3)
    mask = rng.random(400) > 0.1
    reps = _tie_heavy(rng, 24, 4)
    rmask = rng.random(24) > 0.3
    want = jfilt.filter_by_representatives(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(reps),
        jnp.asarray(rmask), impl="jnp")
    got = tfilt.filter_by_representatives(
        torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(reps),
        torch.from_numpy(rmask), impl="torch")
    _eq(got, np.asarray(want))


@pytest.mark.parametrize("strategy", ["random", "angular", "sliced", "grid"])
def test_pd_row_mask_and_relative_skyline_match_jax(strategy):
    rng = np.random.default_rng(4)
    p, r, d = 6, 120, 3
    ref_parts = rng.integers(0, p, r).astype(np.int32)
    cells = rng.integers(0, 3, (p, d)).astype(np.int32)
    ref_cells = cells[ref_parts]
    refs = _tie_heavy(rng, r, d)
    rmask = rng.random(r) > 0.2
    u = _tie_heavy(rng, p * 50, d).reshape(p, 50, d)
    um = rng.random((p, 50)) > 0.1
    pd_t = tnoseq.pd_row_mask(strategy, torch.arange(p),
                              torch.from_numpy(ref_parts),
                              torch.from_numpy(cells),
                              torch.from_numpy(ref_cells))
    keep_t = tnoseq.relative_skyline_mask(
        torch.from_numpy(u), torch.from_numpy(um), torch.from_numpy(refs),
        torch.from_numpy(rmask), pd_t, impl="torch")
    for i in range(p):
        pd_j = jnoseq.pd_row_mask(strategy, jnp.int32(i),
                                  jnp.asarray(ref_parts),
                                  jnp.asarray(cells[i]),
                                  jnp.asarray(ref_cells))
        _eq(pd_t[i], np.asarray(pd_j), f"pd {i}")
        _eq(tnoseq.pd_row_mask(strategy, i, torch.from_numpy(ref_parts),
                               torch.from_numpy(cells[i]),
                               torch.from_numpy(ref_cells)),
            np.asarray(pd_j), f"unbatched pd {i}")
        keep_j = jnoseq.relative_skyline_mask(
            jnp.asarray(u[i]), jnp.asarray(um[i]), jnp.asarray(refs),
            jnp.asarray(rmask), pd_j, impl="jnp")
        _eq(keep_t[i], np.asarray(keep_j), f"relative skyline {i}")


def _run_both(x, mask, **cfg_kw):
    """Every leaf and every stat of parallel_skyline, port against JAX."""
    jcfg = jpar.SkyConfig(impl="perpair", **cfg_kw)
    jbuf, jstats = jpar.parallel_skyline(
        jnp.asarray(x), None if mask is None else jnp.asarray(mask),
        cfg=jcfg)
    tcfg = convert.config_from_reference(
        dict(dataclasses.asdict(jcfg), impl="auto"))
    tbuf, tstats = tapi.parallel_skyline(x, mask, cfg=tcfg, device="cpu")
    for g, w, name in zip(tbuf, jbuf, ("points", "mask", "count",
                                       "overflow")):
        _eq(g, np.asarray(w), f"{name} differs for {cfg_kw}")
    assert set(tstats) == set(jstats)
    for k in jstats:
        assert tstats[k].numpy().dtype == np.asarray(jstats[k]).dtype, k
        _eq(tstats[k], np.asarray(jstats[k]), f"stat {k} for {cfg_kw}")
    return tbuf, tstats


@pytest.mark.parametrize("kind", ["uniform", "anticorrelated", "ties"])
@pytest.mark.parametrize("opt", [dict(rep_filter="sorted"),
                                 dict(rep_filter="region"),
                                 dict(noseq=True),
                                 dict(rep_filter="sorted", noseq=True)],
                         ids=["sorted", "region", "noseq", "sorted+noseq"])
def test_parallel_skyline_options_match_jax(kind, opt):
    rng = np.random.default_rng(5)
    n, d = 900, 3
    if kind == "uniform":
        x = rng.random((n, d)).astype(np.float32)
    elif kind == "anticorrelated":
        x = _anticorrelated(rng, n, d)
    else:
        x = _tie_heavy(rng, n, d, zero_rows=6)
    mask = rng.random(n) > 0.1
    buf, stats = _run_both(x, mask, p=4, rep_k=8, **opt)
    assert not bool(buf.overflow)
    # the final skyline does not depend on the optimisation
    plain, _ = tapi.parallel_skyline(
        x, mask, cfg=tapi.SkyConfig(p=4), device="cpu")
    for g, w in zip(buf, plain):
        _eq(g, w.numpy())


@pytest.mark.parametrize("opt", [dict(rep_filter="sorted"), dict(noseq=True)])
def test_options_overflow_and_tiny_inputs(opt):
    rng = np.random.default_rng(6)
    x = _anticorrelated(rng, 1200, 4)
    buf, _ = _run_both(x, None, capacity=20, **opt)
    assert bool(buf.overflow)
    for n in (0, 5):
        _run_both(rng.random((n, 3)).astype(np.float32), None, p=3, **opt)
    _run_both(x[:300], np.zeros(300, bool), **opt)


def test_random_representatives_give_the_reference_buffer():
    rng = np.random.default_rng(7)
    x = _anticorrelated(rng, 800, 4)
    jbuf, _ = jpar.parallel_skyline(
        jnp.asarray(x), cfg=jpar.SkyConfig(impl="perpair", p=4,
                                           rep_filter="random"))
    cfg = tapi.SkyConfig(p=4, rep_filter="random")
    for gen in (None, torch.Generator().manual_seed(3)):
        tbuf, stats = tapi.parallel_skyline(x, cfg=cfg, device="cpu",
                                            generator=gen)
        for g, w in zip(tbuf, jbuf):
            _eq(g, np.asarray(w))
        assert stats["rep_filter_dropped"].dtype == torch.int32


@settings(max_examples=12, deadline=None, database=None)
@given(st.sampled_from([None, "sorted", "region"]), st.booleans(),
       st.integers(0, 2 ** 31 - 1))
def test_hypothesis_full_pipeline_matches_jax(rep, noseq, seed):
    """Sliced strategy, quantised data: every leaf and stat, and the set
    against the O(N^2) oracle."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(30, 300))
    d = int(rng.integers(2, 6))
    x = (rng.integers(0, 8, (n, d)) / 8.0).astype(np.float32)
    buf, _ = _run_both(x, None, p=4, capacity=max(n, 16), block=32,
                       bucket_factor=float(n), rep_filter=rep, rep_k=4,
                       noseq=noseq)
    assert not bool(buf.overflow)
    members = tapi.skyline_mask_exact(x, device="cpu").numpy()
    got = set(map(tuple, buf.points[buf.mask].numpy().tolist()))
    assert got == set(map(tuple, x[members].tolist()))


@pytest.mark.parametrize("d,m", [(1, 3), (2, 4), (3, 2), (4, 3), (6, 2)])
@pytest.mark.parametrize("kind", ["uniform", "ties"])
def test_grid_filter_matches_jax(d, m, kind):
    """The kept mask, the pruned cells and the dropped count."""
    rng = np.random.default_rng(40 + d * m)
    if kind == "uniform":
        x = rng.random((700, d)).astype(np.float32)
    else:
        x = _tie_heavy(rng, 700, d, levels=m + 1, zero_rows=5)
    mask = rng.random(700) > 0.15
    want = jfilt.grid_filter(jnp.asarray(x), jnp.asarray(mask), m)
    got = tfilt.grid_filter(torch.from_numpy(x), torch.from_numpy(mask), m)
    for g, w, name in zip(got, want, tfilt.GridFilterResult._fields):
        assert g.numpy().dtype == np.asarray(w).dtype, name
        _eq(g, np.asarray(w), name)
    # every dropped row is dominated by a kept one
    members = tapi.skyline_mask_exact(x, mask, device="cpu").numpy()
    assert not (members & ~got.mask.numpy()).any()


@pytest.mark.parametrize("grid_filter", [True, False])
@pytest.mark.parametrize("opt", [dict(noseq=True),
                                 dict(noseq=True, rep_filter="sorted")],
                         ids=["noseq", "noseq+sorted"])
def test_grid_noseq_with_cells_matches_jax(grid_filter, opt):
    """NoSeq under the grid strategy reads each partition's cell: the
    potential dominators are the rows of weakly smaller cells."""
    rng = np.random.default_rng(8)
    x = _anticorrelated(rng, 900, 3)
    mask = rng.random(900) > 0.1
    buf, stats = _run_both(x, mask, strategy="grid", p=8, bucket_factor=6.0,
                           grid_filter=grid_filter, rep_k=8, **opt)
    assert ("grid_filter_dropped" in stats) == grid_filter
    assert not bool(buf.overflow)
    plain, _ = tapi.parallel_skyline(x, mask, cfg=tapi.SkyConfig(p=4),
                                     device="cpu")
    for g, w in zip(buf, plain):
        _eq(g, w.numpy())
