"""The port's SFS sweep and block-SFS against the JAX package, bit for bit.

The plain sweep (``impl='torch'``) and the per-pair oracle
(``impl='perpair'``) of ``repro_torch`` take the same sorted, padded
numpy inputs as the JAX package's ``sfs_sweep`` with ``spec='perpair'``
and ``spec='jnp'`` (JAX on the CPU).  Every leaf is compared: the window
through its int32 bits (so ``-0.0`` must stay ``-0.0``), the mask, the
count and the overflow flag.  Tolerance: zero.  The case grid is that of
tests/test_sfs_kernel.py: ties and duplicates, masked rows, overflow at a
capacity far below n, n not a multiple of the block, block 2, d 12.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import sfs as jsfs
from repro.kernels.sfs import ops as jops
from repro_torch.core import sfs as tsfs
from repro_torch.core.dominance import SENTINEL
from repro_torch.kernels.sfs import ops as tops


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends: each
    keeps memory mappings of its machine code, and a test worker that
    runs several such modules would reach the kernel's map limit
    (vm.max_map_count), where XLA's next compile crashes the worker."""
    yield
    jax.clear_caches()
    gc.collect()


CASES = [  # (P, n, d, capacity, block)
    (1, 1, 2, 4, 8),
    (2, 7, 3, 8, 4),
    (1, 100, 2, 100, 64),
    (3, 257, 5, 300, 64),        # n not a multiple of the block
    (2, 513, 3, 64, 32),         # overflow: capacity << n
    (4, 300, 7, 128, 128),
    (1, 1000, 4, 2048, 256),
    (2, 40, 3, 40, 2),           # block 2
    (2, 120, 12, 120, 32),       # d 12
]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_leaves_equal(got, want, ctx):
    for g, w, name in zip(got, want, ("points", "mask", "count",
                                      "overflow")):
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{name} differs {ctx}")


def _batch(rng, p, n, d, levels=5, mask_frac=0.2):
    """Quantised coordinates (plenty of ties and duplicates), -0.0 in
    some of them, and masked rows."""
    pts = (rng.integers(0, levels, (p, n, d)) / levels).astype(np.float32)
    pts[rng.random((p, n, d)) < 0.05] = -0.0
    return pts, rng.random((p, n)) > mask_frac


def _sweep_inputs(pts, mask, capacity, block):
    """The sweep's input, made once by the port's presort and handed to
    both sides as numpy arrays."""
    pts_p, mask_p, block, wcap = tsfs.sweep_inputs(
        torch.from_numpy(pts), torch.from_numpy(mask), capacity=capacity,
        block=block)
    return pts_p.numpy(), mask_p.numpy(), dict(block=block, wcap=wcap)


def _np(leaves):
    return [np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()
            for x in leaves]


@pytest.mark.parametrize("p,n,d,cap,blk", CASES)
def test_sweep_matches_jax(p, n, d, cap, blk):
    rng = np.random.default_rng(p * 10_000 + n * 10 + d)
    pts_p, mask_p, kw = _sweep_inputs(*_batch(rng, p, n, d), cap, blk)
    kw["sentinel"] = SENTINEL
    wants = {impl: _np(jops.sfs_sweep(jnp.asarray(pts_p), jnp.asarray(mask_p),
                                      spec=impl, **kw))
             for impl in ("perpair", "jnp")}
    for impl in ("torch", "perpair"):
        got = _np(tops.sfs_sweep(torch.from_numpy(pts_p),
                                 torch.from_numpy(mask_p), spec=impl, **kw))
        for ref, want in wants.items():
            _assert_leaves_equal(got, want, f"port {impl} vs jax {ref}")


@pytest.mark.parametrize("p,n,d,cap,blk", CASES[2:7])
def test_local_skyline_batch_matches_jax(p, n, d, cap, blk):
    rng = np.random.default_rng(n + d)
    pts, mask = _batch(rng, p, n, d)
    want = jsfs.local_skyline_batch(jnp.asarray(pts), jnp.asarray(mask),
                                    capacity=cap, block=blk, impl="perpair")
    got = tsfs.local_skyline_batch(torch.from_numpy(pts),
                                   torch.from_numpy(mask), capacity=cap,
                                   block=blk, impl="torch")
    _assert_leaves_equal(_np(got), _np(want), f"shape={(p, n, d)}")


@pytest.mark.parametrize("cap", [400, 40])
def test_block_sfs_matches_jax(cap):
    rng = np.random.default_rng(13)
    pts = rng.random((400, 5)).astype(np.float32)
    want = jsfs.block_sfs(jnp.asarray(pts), capacity=cap, block=64,
                          impl="perpair")
    got = tsfs.block_sfs(torch.from_numpy(pts), capacity=cap, block=64)
    _assert_leaves_equal(_np(got), _np(want), f"cap={cap}")
    assert bool(got.overflow) == (cap == 40)


def test_negative_zero_bits_preserved():
    pts = np.asarray([[[-0.0, 0.5], [0.25, 0.25], [0.5, -0.0],
                       [0.75, -1.0], [1.0, 1.0], [0.125, 0.625]]],
                     np.float32)
    want = jsfs.local_skyline_batch(jnp.asarray(pts), capacity=6, block=2,
                                    impl="perpair")
    assert np.signbit(np.asarray(want.points)).any()
    for impl in ("torch", "perpair"):
        got = tsfs.local_skyline_batch(torch.from_numpy(pts), capacity=6,
                                       block=2, impl=impl)
        _assert_leaves_equal(_np(got), _np(want), f"impl={impl}")


def test_all_masked_and_empty_partitions():
    rng = np.random.default_rng(3)
    pts = rng.random((2, 64, 3)).astype(np.float32)
    mask = np.zeros((2, 64), bool)
    mask[1, :5] = True
    want = jsfs.local_skyline_batch(jnp.asarray(pts), jnp.asarray(mask),
                                    capacity=16, block=16, impl="perpair")
    got = tsfs.local_skyline_batch(torch.from_numpy(pts),
                                   torch.from_numpy(mask), capacity=16,
                                   block=16)
    _assert_leaves_equal(_np(got), _np(want), "masked")
    assert int(got.count[0]) == 0


WTILES = (-1, 0, 7, 33, 64, 100, 128, 256, 10_000)


def test_normalize_wtile_matches_jax():
    for wcap, block in ((256, 64), (96, 32), (100, 64)):
        for wtile in WTILES:
            assert tops._normalize_wtile(wtile, wcap, block) == \
                jops._normalize_wtile(wtile, wcap, block), (wtile, wcap)


def test_wtile_changes_no_bit():
    rng = np.random.default_rng(41)
    pts, mask = _batch(rng, 1, 300, 4)
    want = jsfs.local_skyline_batch(jnp.asarray(pts), jnp.asarray(mask),
                                    capacity=256, block=64, impl="perpair")
    for wtile in WTILES:
        got = tsfs.local_skyline_batch(torch.from_numpy(pts),
                                       torch.from_numpy(mask), capacity=256,
                                       block=64, wtile=wtile)
        _assert_leaves_equal(_np(got), _np(want), f"wtile={wtile}")


def test_naive_skyline_mask_matches_jax():
    rng = np.random.default_rng(5)
    pts, mask = _batch(rng, 1, 2500, 3)   # more rows than one oracle chunk
    want = jsfs.naive_skyline_mask(jnp.asarray(pts[0]), jnp.asarray(mask[0]))
    got = tsfs.naive_skyline_mask(torch.from_numpy(pts[0]),
                                  torch.from_numpy(mask[0]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compact_matches_jax():
    rng = np.random.default_rng(9)
    pts, mask = _batch(rng, 1, 200, 3, mask_frac=0.6)
    for cap in (200, 50):
        want = jsfs.compact(jnp.asarray(pts[0]), jnp.asarray(mask[0]), cap)
        got = tsfs.compact(torch.from_numpy(pts[0]),
                           torch.from_numpy(mask[0]), cap)
        _assert_leaves_equal(_np(got), _np(want), f"cap={cap}")


@settings(max_examples=12, deadline=None, database=None)
@given(st.integers(1, 3), st.integers(1, 90), st.integers(2, 6),
       st.integers(0, 3), st.sampled_from([16, 32]),
       st.integers(0, 2 ** 31 - 1))
def test_hypothesis_sweep_parity(p, n, d, quant, blk, seed):
    """Property: the plain sweep is bit for bit the JAX per-pair sweep on
    random data with heavy ties, duplicates, masked rows, and capacities
    small enough to overflow."""
    rng = np.random.default_rng(seed)
    levels = [3, 5, 17, 0][quant]
    if levels:
        pts, mask = _batch(rng, p, n, d, levels, mask_frac=0.25)
    else:
        pts = rng.random((p, n, d)).astype(np.float32)
        mask = rng.random((p, n)) > 0.25
    cap = int(rng.integers(1, n + 1))
    want = jsfs.local_skyline_batch(jnp.asarray(pts), jnp.asarray(mask),
                                    capacity=cap, block=blk, impl="perpair")
    got = tsfs.local_skyline_batch(torch.from_numpy(pts),
                                   torch.from_numpy(mask), capacity=cap,
                                   block=blk)
    _assert_leaves_equal(_np(got), _np(want),
                         f"p={p} n={n} d={d} cap={cap} blk={blk}")
