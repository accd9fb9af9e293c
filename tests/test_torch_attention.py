"""The port's attention (`repro_torch.models.attention`) and norm against
``repro.models.attention`` / ``repro.models.common`` on the CPU.

* Exactly: ``mask_block`` for all five kinds, the GQA repeat,
  ``cache_from_prefill`` (full and rolling, shorter and longer than the
  capacity) given the same k/v, and in ``attention_decode`` the slot
  written (``pos % W`` rolling, ``min(pos, W - 1)`` otherwise), its
  ``kpos``, and every other slot unchanged.
* f32 compute, rtol = atol = 1e-4: ``rmsnorm``, the RoPE frequencies and
  ``apply_rope``, ``attention_train`` on the full path and on the
  blockwise (online-softmax) path, forced with a small
  ``blockwise_threshold`` and ``block_k``, for every mask kind, with and
  without qk-norm; and ``attention_decode``'s output.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import F32_TOL, assert_bits, assert_close
from repro.models import attention as jatt
from repro.models import common as jcommon
from repro_torch import convert
from repro_torch.models import attention as tatt
from repro_torch.models import common as tcommon
from repro_torch.models.common import init_params

KINDS = {"causal": {}, "window": {"window": 5}, "chunk": {"chunk": 4},
         "bidir": {}, "prefix": {"prefix_len": 6}}


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends (memory
    mappings; see ``tests/test_torch_scheduler.py``)."""
    yield
    jax.clear_caches()
    gc.collect()


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_rmsnorm():
    x, scale = _rand((3, 5, 16), 0) * 3, _rand((16,), 1) * 0.1
    got = tcommon.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale))
    want = jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(scale))
    assert_close(got, want, F32_TOL)
    half = tcommon.rmsnorm(torch.from_numpy(x).to(torch.bfloat16),
                           torch.from_numpy(scale))
    assert half.dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [1e4, 5e6])
def test_rope(theta):
    freqs = tatt.init_rope(16, theta)
    jfreqs = jatt.init_rope(16, theta)
    assert_close(freqs, jfreqs, F32_TOL, "frequencies")
    x = _rand((2, 4, 11, 16), 2)
    pos = np.arange(3, 14)
    got = tatt.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), freqs)
    want = jatt.apply_rope(jnp.asarray(x), jnp.asarray(pos), jfreqs)
    assert_close(got, want, F32_TOL, "rotated")


@pytest.mark.parametrize("kind", list(KINDS))
def test_mask_block_is_exact(kind):
    q = np.arange(4, 13)
    for k in (np.arange(0, 16), np.arange(8, 12)):
        got = tatt.mask_block(kind, torch.from_numpy(q), torch.from_numpy(k),
                              **KINDS[kind])
        want = jatt.mask_block(kind, jnp.asarray(q), jnp.asarray(k),
                               **KINDS[kind])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_repeat_kv_is_exact():
    k = _rand((2, 2, 5, 4), 3)
    got = tatt._repeat_kv(torch.from_numpy(k), 6)
    assert_bits(got, np.asarray(jatt._repeat_kv(jnp.asarray(k), 6)))


def _attn_params(d, hq, hkv, dh, qk_norm, seed):
    plan = tatt.attn_plan(d, hq, hkv, dh, qk_norm)
    params = init_params(plan, seed=seed, device="cpu")
    if qk_norm:   # non-zero norm scales
        params["q_norm"] = torch.from_numpy(_rand((dh,), seed + 1) * 0.1)
        params["k_norm"] = torch.from_numpy(_rand((dh,), seed + 2) * 0.1)
    return params, jax.tree.map(jnp.asarray, convert.params_to_numpy(params))


@pytest.mark.parametrize("blockwise", [False, True])
@pytest.mark.parametrize("kind", list(KINDS))
def test_attention_train(kind, blockwise):
    qk_norm = kind in ("causal", "prefix")
    params, jparams = _attn_params(16, 4, 2, 8, qk_norm, seed=4)
    x = _rand((2, 16, 16), 5)
    kw = dict(n_heads=4, n_kv=2, head_dim=8, kind=kind, qk_norm=qk_norm,
              block_k=4, blockwise_threshold=8 if blockwise else 8192,
              **KINDS[kind])
    use_rope = kind != "bidir"
    (k, v), y = tatt.attention_train(
        params, torch.from_numpy(x), compute_dtype=torch.float32,
        rope_freqs=tatt.init_rope(8) if use_rope else None, **kw)
    (jk, jv), jy = jax.jit(lambda p, v: jatt.attention_train(
        p, v, compute_dtype=jnp.float32,
        rope_freqs=jatt.init_rope(8) if use_rope else None, **kw))(
        jparams, jnp.asarray(x))
    assert_close(y, jy, F32_TOL, "output")
    assert_close(k, jk, F32_TOL, "k")
    assert_close(v, jv, F32_TOL, "v")
    if blockwise:   # the online softmax is the full softmax
        _, full = tatt.attention_train(
            params, torch.from_numpy(x), compute_dtype=torch.float32,
            rope_freqs=tatt.init_rope(8) if use_rope else None,
            **{**kw, "blockwise_threshold": 8192})
        assert_close(y, full, F32_TOL, "blockwise against full")


@pytest.mark.parametrize("s,capacity,rolling", [
    (6, 10, False), (10, 10, False), (6, 8, True), (13, 8, True),
    (16, 8, True)])
def test_cache_from_prefill_is_exact(s, capacity, rolling):
    k, v = _rand((3, 2, 2, s, 4), 6), _rand((3, 2, 2, s, 4), 7)
    got = tatt.cache_from_prefill(torch.from_numpy(k), torch.from_numpy(v),
                                  capacity, rolling)
    want = jax.vmap(lambda a, b: jatt.cache_from_prefill(
        a, b, capacity, rolling))(jnp.asarray(k), jnp.asarray(v))
    assert got.rolling == want.rolling == rolling
    for name in ("k", "v", "kpos"):
        assert_bits(getattr(got, name), np.asarray(getattr(want, name)), name)


@pytest.mark.parametrize("rolling,kind,pos", [
    (False, "causal", 5), (False, "causal", 12),     # clamps at W - 1
    (True, "window", 13), (True, "chunk", 9), (False, "causal", 0)])
def test_attention_decode(rolling, kind, pos):
    w = 8
    params, jparams = _attn_params(16, 4, 2, 8, True, seed=8)
    cache_k, cache_v = _rand((2, w, 2, 8), 9), _rand((2, w, 2, 8), 10)
    kpos = np.where(np.arange(w) < 6, np.arange(w) + max(pos - 6, 0),
                    -1).astype(np.int32)
    x = _rand((2, 1, 16), 11)
    kw = dict(n_heads=4, n_kv=2, head_dim=8, kind=kind, window=5, chunk=4,
              qk_norm=True)
    cache = tatt.KVCache(torch.from_numpy(cache_k),
                         torch.from_numpy(cache_v), torch.from_numpy(kpos),
                         rolling)
    new, y = tatt.attention_decode(
        params, torch.from_numpy(x), cache,
        torch.tensor(pos, dtype=torch.int32), compute_dtype=torch.float32,
        rope_freqs=tatt.init_rope(8), **kw)
    jcache = jatt.KVCache(jnp.asarray(cache_k), jnp.asarray(cache_v),
                          jnp.asarray(kpos), rolling)
    jnew, jy = jax.jit(lambda p, v, c, q: jatt.attention_decode(
        p, v, c, q, compute_dtype=jnp.float32, rope_freqs=jatt.init_rope(8),
        **kw))(jparams, jnp.asarray(x), jcache, jnp.int32(pos))
    assert_close(y, jy, F32_TOL, "output")
    slot = pos % w if rolling else min(pos, w - 1)
    assert_bits(new.kpos, np.asarray(jnew.kpos), "kpos")
    assert int(new.kpos[slot]) == pos
    others = np.arange(w) != slot
    for name, before in (("k", cache_k), ("v", cache_v)):
        got = getattr(new, name).numpy()
        assert_bits(got[:, others], before[:, others], f"{name} unwritten")
        assert_close(got[:, slot], np.asarray(getattr(jnew, name))[:, slot],
                     F32_TOL, f"{name} written")
