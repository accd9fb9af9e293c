"""The port's dominance entry against the JAX package, bit for bit.

``repro_torch.kernels.dominance.ops.dominated_mask`` with the plain
``'torch'`` version runs on the same numpy inputs as
``repro.kernels.dominance.dominated_mask`` with ``'jnp'`` and with the
TPU kernel body in ``'interpret'`` mode (JAX on the CPU).  Tolerance:
zero; the outputs are boolean flags and must be equal element for
element.  The batch axis of the port is held against the reference one
batch at a time.  The CUDA kernel is held against the same plain version
on the card by ``chip_smoke.py``.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import sfs as jsfs
from repro.kernels.dominance import dominated_mask as jdominated
from repro_torch.core import sfs as tsfs
from repro_torch.kernels.dominance import ops
from repro_torch.kernels.dominance.ref import dominated_mask_ref

SHAPES = [(1, 1, 2), (7, 3, 2), (64, 64, 4), (130, 513, 5), (300, 40, 7),
          (512, 512, 8), (1000, 257, 3)]


def _port(cands, refs, mask=None, **kw):
    return ops.dominated_mask(
        torch.from_numpy(np.asarray(cands)), torch.from_numpy(np.asarray(refs)),
        None if mask is None else torch.from_numpy(np.asarray(mask)),
        impl="torch", **kw).numpy()


def _jax(cands, refs, mask=None, impl="jnp", dtype=jnp.float32, **kw):
    return np.asarray(jdominated(
        jnp.asarray(cands, dtype), jnp.asarray(refs, dtype),
        None if mask is None else jnp.asarray(mask), impl=impl, **kw))


def _tie_heavy(rng, n, d, levels=4):
    """Quantised coordinates (ties and duplicates), some -0.0."""
    x = (rng.integers(0, levels, (n, d)) / levels).astype(np.float32)
    x[rng.random((n, d)) < 0.1] = -0.0
    return x


@pytest.mark.parametrize("c,r,d", SHAPES)
@pytest.mark.parametrize("impl", ["jnp", "interpret"])
def test_matches_jax(c, r, d, impl):
    rng = np.random.default_rng(c * 1000 + r + d)
    cands = rng.random((c, d)).astype(np.float32)
    refs = rng.random((r, d)).astype(np.float32)
    mask = rng.random(r) > 0.25
    np.testing.assert_array_equal(_port(cands, refs, mask),
                                  _jax(cands, refs, mask, impl))


@pytest.mark.parametrize("impl", ["jnp", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lower_tri_and_dtypes(impl, dtype):
    """bf16 is widened to f32 before the test: exact, so the same bits."""
    rng = np.random.default_rng(0)
    x = rng.random((200, 4)).astype(np.float32)
    want = _jax(x, x, None, impl, dtype=getattr(jnp, dtype), lower_tri=True)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ops.dominated_mask(xt, xt, None, lower_tri=True, impl="torch")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", ["jnp", "interpret"])
def test_ties_negative_zero_and_duplicates(impl):
    """-0.0 <= +0.0 holds and -0.0 < +0.0 does not, on both sides."""
    rng = np.random.default_rng(4)
    cands = _tie_heavy(rng, 300, 3)
    refs = np.concatenate([_tie_heavy(rng, 200, 3), cands[:50]])
    mask = rng.random(250) > 0.2
    np.testing.assert_array_equal(_port(cands, refs, mask),
                                  _jax(cands, refs, mask, impl))
    np.testing.assert_array_equal(
        _port(cands, cands, None, lower_tri=True),
        _jax(cands, cands, None, impl, lower_tri=True))
    z = np.array([[-0.0, 1.0], [0.0, 1.0], [0.0, 0.5]], np.float32)
    np.testing.assert_array_equal(_port(z[:2], z[:2]), [False, False])
    np.testing.assert_array_equal(_port(z, z), [True, True, False])


def test_all_masked_refs_dominate_nothing():
    rng = np.random.default_rng(5)
    cands = rng.random((50, 3)).astype(np.float32)
    refs = np.zeros((20, 3), np.float32)    # would dominate everything
    got = _port(cands, refs, np.zeros(20, bool))
    assert not got.any()
    np.testing.assert_array_equal(got, _jax(cands, refs, np.zeros(20, bool)))


def test_wide_d_on_the_plain_version():
    rng = np.random.default_rng(20)
    cands = (rng.integers(0, 3, (150, 20)) / 3.0).astype(np.float32)
    refs = (rng.integers(0, 3, (90, 20)) / 3.0).astype(np.float32)
    mask = rng.random(90) > 0.25
    np.testing.assert_array_equal(_port(cands, refs, mask),
                                  _jax(cands, refs, mask))
    np.testing.assert_array_equal(
        _port(cands, cands, None, lower_tri=True),
        _jax(cands, cands, None, lower_tri=True))


@pytest.mark.parametrize("shared", ["none", "refs", "refs_and_mask"])
def test_batch_axis_matches_per_batch_calls(shared):
    """(B, C, d) candidates against per-batch refs, against refs shared
    by every batch (given 2-D or expanded with batch stride 0), with
    per-batch or shared masks: each batch equals the reference's call."""
    rng = np.random.default_rng(6)
    b, c, r, d = 4, 90, 70, 3
    # continuous data: each batch's flags depend on its own refs
    cands = rng.random((b, c, d)).astype(np.float32)
    refs = rng.random((b, r, d)).astype(np.float32)
    mask = rng.random((b, r)) > 0.3
    if shared != "none":
        refs = np.broadcast_to(refs[:1], refs.shape)
    if shared == "refs_and_mask":
        mask = np.broadcast_to(mask[:1], mask.shape)
    tr = torch.from_numpy(refs[0].copy()).expand(b, r, d)
    tm = (torch.from_numpy(mask[0].copy()).expand(b, r)
          if shared == "refs_and_mask" else torch.from_numpy(mask.copy()))
    if shared == "none":
        tr = torch.from_numpy(refs.copy())
    got = ops.dominated_mask(torch.from_numpy(cands), tr, tm, impl="torch")
    assert got.shape == (b, c)
    for i in range(b):
        np.testing.assert_array_equal(got[i].numpy(),
                                      _jax(cands[i], refs[i], mask[i]))
    if shared != "none":        # 2-D refs are shared the same way
        got2 = ops.dominated_mask(torch.from_numpy(cands),
                                  torch.from_numpy(refs[0].copy()), tm,
                                  impl="torch")
        np.testing.assert_array_equal(got2.numpy(), got.numpy())


@pytest.mark.parametrize("lower_tri", [False, True])
def test_blocking_on_both_axes_changes_no_bit(lower_tri, monkeypatch):
    """The plain version's candidate and reference blocks, forced small,
    give the oracle's bits, including refs masked past the last valid
    row."""
    rng = np.random.default_rng(7)
    x = _tie_heavy(rng, 3 * 301, 4).reshape(3, 301, 4)
    mask = rng.random((3, 301)) > 0.3
    mask[:, 250:] = False
    want = ops.dominated_mask(torch.from_numpy(x), torch.from_numpy(x),
                              torch.from_numpy(mask), lower_tri=lower_tri,
                              impl="torch")
    monkeypatch.setattr(ops, "_REF_BLOCK", 17)
    monkeypatch.setattr(ops, "_PAIR_BUDGET", 3 * 17 * 23)
    got = ops.dominated_mask(torch.from_numpy(x), torch.from_numpy(x),
                             torch.from_numpy(mask), lower_tri=lower_tri,
                             impl="torch")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for i in range(3):
        xi = torch.from_numpy(x[i])
        np.testing.assert_array_equal(
            got[i].numpy(),
            dominated_mask_ref(xi, xi, torch.from_numpy(mask[i]),
                               lower_tri=lower_tri).numpy())


@pytest.mark.parametrize("impl", ["perpair", "interpret"])
def test_skyline_mask_matches_jax(impl):
    rng = np.random.default_rng(8)
    x = _tie_heavy(rng, 600, 4)
    mask = rng.random(600) > 0.1
    want = jsfs.skyline_mask(jnp.asarray(x), jnp.asarray(mask), impl=impl)
    got = tsfs.skyline_mask(x, mask, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jsfs.skyline_mask(jnp.asarray(x), impl=impl)
    got = tsfs.skyline_mask(x, device="cpu", impl="torch")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_empty_inputs():
    e = np.zeros((0, 3), np.float32)
    x = np.ones((5, 3), np.float32)
    assert _port(e, x).shape == (0,)
    assert not _port(x, e).any() and _port(x, e).shape == (5,)


@settings(max_examples=30, deadline=None, database=None)
@given(st.integers(1, 60), st.integers(1, 60), st.integers(2, 8),
       st.booleans(), st.integers(0, 2 ** 31 - 1))
def test_hypothesis_parity(c, r, d, lower_tri, seed):
    rng = np.random.default_rng(seed)
    cands = (rng.integers(0, 4, (c, d)) / 4.0).astype(np.float32)
    refs = cands if lower_tri else (
        rng.integers(0, 4, (r, d)) / 4.0).astype(np.float32)
    mask = rng.random(refs.shape[0]) > 0.3
    np.testing.assert_array_equal(
        _port(cands, refs, mask, lower_tri=lower_tri),
        _jax(cands, refs, mask, "jnp", lower_tri=lower_tri))
