"""The batched partition stage: Q queries routed in the launches of one.

``repro_torch.core.parallel.partition_stage`` on a (Q, N, d) batch runs
every strategy's ids, Grid Filtering and ``bucketize`` along a leading
query axis (one stable sort of all Q x N keys, a batched searchsorted,
one scatter with destinations offset per query).  It is held bit for bit
against the per-query loop it replaced (each query through the stage on
its own) and, for the deterministic strategies, against the reference's
``jax.vmap`` of ``repro.core.parallel.partition_stage`` under ``jit``;
the random strategy draws each query's ids from that query's own
generator (ROADMAP.md, contract 5).  The data carries ties, masked rows,
-0.0 and subnormal coordinates.  The number of sorts must not grow with
Q, and each must be one flat sort of all Q x N keys.  Tolerance: zero.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import parallel as jpar
from repro_torch import convert
from repro_torch.core import dominance as tdom
from repro_torch.core import parallel as tpar
from repro_torch.core import partition as tpart

CONFIGS = {
    "sliced": dict(strategy="sliced", p=4),
    "sliced_dim2": dict(strategy="sliced", p=3, sliced_dim=2),
    "random": dict(strategy="random", p=4),
    "grid": dict(strategy="grid", m=2),
    "grid_nofilter": dict(strategy="grid", m=2, grid_filter=False),
    "angular": dict(strategy="angular", m=2),
    "overflow": dict(strategy="angular", m=2, bucket_factor=0.5),
}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _batch(q, n=150, d=3, seed=0):
    """Tie-heavy data on a grid of quarters with -0.0 and subnormals,
    and a mask that drops a different share of rows in each query (one
    query entirely masked)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 5, (q, n, d)) / 4
    x[rng.random((q, n, d)) < 0.05] = -0.0
    x[rng.random((q, n, d)) < 0.03] = 2e-40
    x = np.clip(x, -0.0, 1.0).astype(np.float32)
    mask = rng.random((q, n)) > rng.random((q, 1)) * 0.5
    mask[q // 2] = False
    return x, mask


def _gens(q, seed=7):
    return [torch.Generator().manual_seed(seed + i) for i in range(q)]


def _leaves(buckets, stats):
    return list(buckets) + [stats[k] for k in sorted(stats)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_batched_stage_equals_per_query_loop(name):
    cfg = tpar.SkyConfig(**CONFIGS[name])
    q = 5
    x, mask = _batch(q, seed=len(name))
    pts, msk = torch.from_numpy(x), torch.from_numpy(mask)
    b, meta, stats = tpar.partition_stage(pts, msk, cfg, _gens(q))
    loop = [tpar.partition_stage(pts[i], msk[i], cfg, g)
            for i, g in enumerate(_gens(q))]
    assert sorted(stats) == sorted(loop[0][2])
    for i, (bi, mi, si) in enumerate(loop):
        got = _leaves(tpart.Buckets(*(leaf[i] for leaf in b)),
                      {k: v[i] for k, v in stats.items()})
        for g, w in zip(got, _leaves(bi, si)):
            np.testing.assert_array_equal(_bits(g.numpy()),
                                          _bits(w.numpy()), err_msg=name)
        assert mi["p"] == meta["p"] and mi["m"] == meta["m"]
        assert torch.equal(mi["cells"], meta["cells"])
    if name == "overflow":
        assert bool(stats["bucket_overflow"].any())


@pytest.mark.parametrize("name", [k for k in CONFIGS if k != "random"])
def test_batched_stage_equals_jax_vmap(name):
    """The deterministic strategies against the reference's vmap of the
    stage under jit (as its batched pipeline runs it)."""
    jcfg = jpar.SkyConfig(**CONFIGS[name])
    tcfg = convert.config_from_reference(dataclasses.asdict(jcfg))
    x, mask = _batch(4, seed=11)

    @jax.jit
    def ref(p, m):
        def one(pi, mi):
            b, _, s = jpar.partition_stage(pi, mi, jcfg)
            return b, s
        return jax.vmap(one)(p, m)

    jb, js = ref(jnp.asarray(x), jnp.asarray(mask))
    tb, _, ts = tpar.partition_stage(torch.from_numpy(x),
                                     torch.from_numpy(mask), tcfg)
    assert sorted(ts) == sorted(js)
    for g, w in zip(_leaves(tb, ts), _leaves(jb, js)):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w),
                                      err_msg=name)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sorts_do_not_grow_with_q(name, monkeypatch):
    """The stage makes the same number of sorts at Q = 2 and Q = 16 (the
    random strategy draws one permutation per query), and each is one
    flat sort of all Q x N keys: a batched sort of rows could be run row
    by row on the card."""
    cfg = tpar.SkyConfig(**CONFIGS[name])
    calls = []
    orig = torch.sort
    monkeypatch.setattr(torch, "sort", lambda v, *a, **k: (
        calls.append(tuple(v.shape)), orig(v, *a, **k))[1])
    counts = []
    for q in (2, 16):
        x, mask = _batch(q, n=64, seed=q)
        calls.clear()
        tpar.partition_stage(torch.from_numpy(x), torch.from_numpy(mask),
                             cfg, _gens(q))
        counts.append(len(calls))
        assert all(shape == (q * 64,) for shape in calls), calls
    assert counts[0] == counts[1] == (2 if name.startswith("sliced")
                                      else 1)


@pytest.mark.parametrize("kind", ["f32", "ids"])
def test_flat_row_sort_equals_per_row_sort(kind):
    """`stable_argsort_rows` gives each row the order of the per-row
    stable sort: ties in input order, -0.0 and subnormals equal to +0.0,
    infinities at the ends, NaN last."""
    rng = np.random.default_rng(5)
    if kind == "f32":
        v = (rng.integers(-3, 4, (6, 200)) / 2).astype(np.float32)
        v[rng.random(v.shape) < 0.05] = -0.0
        v[rng.random(v.shape) < 0.05] = 2e-40
        v[rng.random(v.shape) < 0.05] = -3e-39
        v[rng.random(v.shape) < 0.03] = np.inf
        v[rng.random(v.shape) < 0.03] = -np.inf
        v[rng.random(v.shape) < 0.02] = np.nan
        t = torch.from_numpy(v)
    else:
        t = torch.from_numpy(rng.integers(0, 9, (6, 200)))
    got = tdom.stable_argsort_rows(t)
    for i in range(t.shape[0]):
        want = tdom.stable_argsort(t[i:i + 1], dim=-1)[0]
        assert torch.equal(got[i], want), (kind, i)


def test_one_generator_draws_query_after_query():
    """A single generator with a batch draws each query's ids in turn,
    as the streaming batch insert has always drawn them."""
    cfg = tpar.SkyConfig(strategy="random", p=4)
    x, mask = _batch(3, seed=2)
    pts, msk = torch.from_numpy(x), torch.from_numpy(mask)
    b, _, _ = tpar.partition_stage(pts, msk, cfg,
                                   torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    for i in range(3):
        bi, _, _ = tpar.partition_stage(pts[i], msk[i], cfg, g)
        assert torch.equal(b.points[i].view(torch.int32),
                           bi.points.view(torch.int32))
    with pytest.raises(ValueError, match="generators for"):
        tpar.partition_stage(pts, msk, cfg, _gens(2))
