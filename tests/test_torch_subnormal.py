"""Subnormal coordinates: the port flushes them as the JAX package does.

XLA on the CPU (like a TPU) treats an f32 subnormal operand of a
comparison or of arithmetic as a zero of its sign, flushes subnormal
results the same way, keeps the stored bits where data only moves, and
sorts subnormals equal to both zeros, stably.  The port follows it
(``repro_torch.core.dominance.flush_subnormal``).  Inputs here mix
subnormals of both signs, +0.0, -0.0 and normal values; the same numpy
arrays go through both packages (JAX on the CPU, impls ``'jnp'`` and
``'perpair'``).  Tolerance: zero; f32 results through their int32 bits.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dominance as jdom
from repro.core import incremental as jinc
from repro.core import parallel as jpar
from repro.core import partition as jpart
from repro.kernels.dominance import dominated_mask as jdominated
from repro.kernels.sfs import ops as jsops
from repro_torch import convert
from repro_torch.core import api as tapi
from repro_torch.core import dominance as tdom
from repro_torch.core import incremental as tinc
from repro_torch.core import partition as tpart
from repro_torch.core import sfs as tsfs
from repro_torch.kernels.dominance import ops as tdops
from repro_torch.kernels.sfs import ops as tsops


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends: each
    keeps memory mappings of its machine code, and a test worker that
    runs several such modules would reach the kernel's map limit
    (vm.max_map_count), where XLA's next compile crashes the worker."""
    yield
    jax.clear_caches()
    gc.collect()


# (1e-40, 1) and (2e-40, 1) tie once flushed, so neither dominates the
# other; kept, the first dominates the second
WITNESS = np.array([[1e-40, 1.0], [2e-40, 1.0], [0.5, 0.5]], np.float32)
DIMS = range(1, 7)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)),
                                  err_msg=msg)


def _mix(seed, n, d):
    """Coordinates drawn from subnormals of both signs and several
    magnitudes, both zeros and a few normal levels, so that flushing
    changes orders, ties and dominance on many rows."""
    rng = np.random.default_rng(seed)
    levels = np.array([1e-45, 1e-42, 3e-40, 1e-39, 1.1e-38, -1e-45, -2e-40,
                       0.0, -0.0, 0.25, 0.5, 0.75, 1.0], np.float32)
    x = levels[rng.integers(0, len(levels), (n, d))]
    return x, rng.random(n) > 0.1


def test_flush_subnormal_keeps_the_rest():
    x = np.array([1e-40, -1e-40, 0.0, -0.0, 1.2e-38, -1.2e-38, np.inf,
                  -np.inf, np.nan, 0.5, 1.7e38], np.float32)
    got = tdom.flush_subnormal(torch.from_numpy(x)).numpy()
    want = x.copy()
    want[:2] = [0.0, -0.0]
    _eq(got, want)


def test_witness_has_three_members():
    jbuf, _ = jpar.parallel_skyline(jnp.asarray(WITNESS))
    tbuf, _ = tapi.parallel_skyline(WITNESS, device="cpu")
    assert int(jbuf.count) == int(tbuf.count) == 3
    for g, w in zip(tbuf, jbuf):
        _eq(g, w)
    mask = tapi.skyline_mask_exact(WITNESS, device="cpu")
    assert mask.all()


@pytest.mark.parametrize("d", DIMS)
def test_score_order_and_slices_match_jax(d):
    x, mask = _mix(d, 400, d)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    _eq(tdom.monotone_score(tx, tm),
        jdom.monotone_score(jnp.asarray(x), jnp.asarray(mask)), "score")
    _eq(tdom.canonical_order(tx, tm),
        jdom.canonical_order(jnp.asarray(x), jnp.asarray(mask)), "order")
    for p in (3, 8):
        _eq(tpart.sliced_part_ids(tx, tm, p, dim=d - 1),
            jpart.sliced_part_ids(jnp.asarray(x), jnp.asarray(mask), p,
                                  dim=d - 1), f"sliced p={p}")


def test_one_attribute_score_keeps_the_bits():
    x = np.array([[1e-40], [-1e-40]], np.float32)
    got = tdom.monotone_score(torch.from_numpy(x)).numpy()
    _eq(got, np.asarray(jdom.monotone_score(jnp.asarray(x))))
    assert got.view(np.int32).tolist() == [71362, -2147412286]


@pytest.mark.parametrize("d", DIMS)
def test_dominated_mask_matches_jax(d):
    x, mask = _mix(10 + d, 300, d)
    want = np.asarray(jdominated(jnp.asarray(x), jnp.asarray(x),
                                 jnp.asarray(mask), impl="jnp"))
    got = tdops.dominated_mask(torch.from_numpy(x), torch.from_numpy(x),
                               torch.from_numpy(mask), impl="torch")
    _eq(got, want)
    tri = np.asarray(jdominated(jnp.asarray(x), jnp.asarray(x),
                                jnp.asarray(mask), lower_tri=True,
                                impl="jnp"))
    _eq(tdops.dominated_mask(torch.from_numpy(x), torch.from_numpy(x),
                             torch.from_numpy(mask), lower_tri=True,
                             impl="torch"), tri, "lower_tri")
    # shared references (batch stride 0) flush the same way
    got = tdops.dominated_mask(torch.from_numpy(np.stack([x, x[::-1]])),
                               torch.from_numpy(x), torch.from_numpy(mask),
                               impl="torch")
    _eq(got[0], want, "batch 0")


@pytest.mark.parametrize("d", DIMS)
def test_sweep_matches_jax(d):
    x, mask = _mix(20 + d, 2 * 250, d)
    pts_p, mask_p, block, wcap = tsfs.sweep_inputs(
        torch.from_numpy(x.reshape(2, 250, d)),
        torch.from_numpy(mask.reshape(2, 250)), capacity=64, block=32)
    kw = dict(block=block, wcap=wcap, sentinel=tdom.SENTINEL)
    for jimpl in ("perpair", "jnp"):
        want = jsops.sfs_sweep(jnp.asarray(pts_p.numpy()),
                               jnp.asarray(mask_p.numpy()), spec=jimpl, **kw)
        for timpl in ("torch", "perpair"):
            got = tsops.sfs_sweep(pts_p, mask_p, spec=timpl, **kw)
            for g, w, name in zip(got, want, ("window", "mask", "count")):
                _eq(g, w, f"{name} {timpl} vs {jimpl}")


def _both_parallel(x, mask, **cfg_kw):
    jcfg = jpar.SkyConfig(impl="perpair", **cfg_kw)
    jbuf, jstats = jpar.parallel_skyline(jnp.asarray(x), jnp.asarray(mask),
                                         cfg=jcfg)
    tcfg = convert.config_from_reference(
        dict(dataclasses.asdict(jcfg), impl="auto"))
    tbuf, tstats = tapi.parallel_skyline(x, mask, cfg=tcfg, device="cpu")
    for g, w, name in zip(tbuf, jbuf, ("points", "mask", "count",
                                       "overflow")):
        _eq(g, w, f"{name} {cfg_kw}")
    assert set(tstats) == set(jstats)
    for k in jstats:
        _eq(tstats[k], jstats[k], f"stat {k} {cfg_kw}")


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("opt", [{}, dict(rep_filter="sorted"),
                                 dict(rep_filter="region"),
                                 dict(noseq=True)],
                         ids=["default", "sorted", "region", "noseq"])
def test_parallel_skyline_matches_jax(d, opt):
    x, mask = _mix(30 + d, 600, d)
    _both_parallel(x, mask, p=4, capacity=256, block=64, **opt)


@pytest.mark.parametrize("d", (1, 3, 6))
def test_two_streaming_inserts_match_jax(d):
    x, mask = _mix(40 + d, 400, d)
    jcfg = jpar.SkyConfig(p=4, capacity=256, block=64, bucket_factor=6.0,
                          impl="perpair", donate=False)
    tcfg = convert.config_from_reference(
        dict(dataclasses.asdict(jcfg), impl="auto"))
    js = jinc.init_state(jcfg, d)
    ts = tinc.init_state(tcfg, d, device="cpu")
    for step, (c0, c1) in enumerate([(0, 150), (150, 400)]):
        js, jstats = jinc.insert_chunk_fn(jcfg)(
            js, jnp.asarray(x[c0:c1]), jnp.asarray(mask[c0:c1]),
            jax.random.PRNGKey(step))
        ts, tstats = tinc.insert_chunk(ts, x[c0:c1], mask[c0:c1], cfg=tcfg)
        for name, g, w in zip(tinc.SkylineState._fields, ts, js):
            _eq(g, w, f"state.{name} at step {step}")
        for k in jstats:
            _eq(tstats[k], jstats[k], f"stat {k} at step {step}")
    for g, w in zip(tinc.finalize(ts, cfg=tcfg), jinc.finalize(js, cfg=jcfg)):
        _eq(g, w, "finalize")
