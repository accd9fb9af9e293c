"""The port's streaming inserts against the JAX package, bit for bit.

``repro_torch.core.incremental`` (``init_state`` / ``insert_chunk`` /
``finalize``, one state or Q) runs on the same numpy chunks as the
reference's ``insert_chunk_fn`` / ``insert_chunk_batch_fn`` /
``finalize`` with ``impl='perpair'`` (JAX on the CPU).  After every
insert every leaf of the state and every stat is compared, and the
snapshot is compared with the one-shot ``parallel_skyline`` answer of
both packages.  Tolerance: zero; f32 leaves through their int32 bits.
The configs are the sliced ones of ``tests/test_streaming.py``.
"""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import incremental as jinc
from repro.core import parallel as jpar
from repro_torch import convert
from repro_torch.core import api as tapi
from repro_torch.core import incremental as tinc


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends: each
    keeps memory mappings of its machine code, and a test worker that
    runs several such modules would reach the kernel's map limit
    (vm.max_map_count), where XLA's next compile crashes the worker."""
    yield
    jax.clear_caches()
    gc.collect()


SLICED = dict(strategy="sliced", p=4, capacity=512, block=64,
              bucket_factor=6.0, impl="perpair", donate=False)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == np.asarray(want).dtype, msg
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=msg)


def _dataset(seed, n=320, d=4):
    """Anticorrelated data salted with duplicates and dominated rows."""
    rng = np.random.default_rng(seed)
    jit = rng.random((n, d)) - 0.5
    x = 0.5 + 0.05 * rng.standard_normal((n, 1)) \
        + 0.9 * (jit - jit.mean(axis=1, keepdims=True))
    x = np.clip(x, 0.0, 1.0).astype(np.float32)
    return np.concatenate([x, x[:n // 8],
                           np.clip(x[:n // 8] + 0.25, 0.0, 1.25)])


class Both:
    """One stream (or Q) kept in both packages, compared after each step."""

    def __init__(self, d, q=None, **cfg_kw):
        self.jcfg = jpar.SkyConfig(**dict(SLICED, **cfg_kw))
        self.tcfg = convert.config_from_reference(
            dict(dataclasses.asdict(self.jcfg), impl="auto"))
        self.j = jinc.init_state(self.jcfg, d, q=q)
        self.t = tinc.init_state(self.tcfg, d, q=q, device="cpu")
        self.q = q
        self.check("init")

    def insert(self, chunk, mask=None, *, step=0):
        chunk = np.asarray(chunk, np.float32)
        if mask is None:
            mask = np.ones(chunk.shape[:-1], bool)
        key = jax.random.fold_in(jax.random.PRNGKey(42), step)
        if self.q is None:
            self.j, jstats = jinc.insert_chunk_fn(self.jcfg)(
                self.j, jnp.asarray(chunk), jnp.asarray(mask), key)
        else:
            self.j, jstats = jinc.insert_chunk_batch_fn(self.jcfg)(
                self.j, jnp.asarray(chunk), jnp.asarray(mask),
                jax.random.split(key, self.q))
        self.t, tstats = tinc.insert_chunk(self.t, chunk, mask, cfg=self.tcfg)
        assert set(tstats) == set(jstats)
        for k in jstats:
            _eq(tstats[k], jstats[k], f"stat {k} at step {step}")
        self.check(f"step {step}")
        return tstats

    def check(self, where):
        for name, g, w in zip(tinc.SkylineState._fields, self.t, self.j):
            _eq(g, w, f"state.{name} at {where}")

    def snapshot(self):
        got = tinc.finalize(self.t, cfg=self.tcfg)
        want = jinc.finalize(self.j, cfg=self.jcfg)
        for g, w in zip(got, want):
            _eq(g, w, "finalize")
        return got


def _assert_stream_equals_oneshot(x, cuts, **cfg_kw):
    both = Both(x.shape[1], **cfg_kw)
    for i in range(len(cuts) - 1):
        both.insert(x[cuts[i]:cuts[i + 1]], step=i)
    out = both.snapshot()
    one, _ = tapi.parallel_skyline(x, cfg=both.tcfg, device="cpu")
    for g, w in zip(out, one):
        _eq(g, w.numpy(), "one-shot")
    assert not bool(out.overflow)
    assert int(both.t.seen) == x.shape[0]
    assert int(both.t.chunks) == len(cuts) - 1
    return out


@pytest.mark.parametrize("opt", [{}, dict(rep_filter="sorted", noseq=True),
                                 dict(rep_filter="region"), dict(noseq=True)],
                         ids=["sliced", "sliced+noseq+rep", "region",
                              "noseq"])
@pytest.mark.parametrize("cuts", [[0, 360], [0, 64, 360],
                                  [0, 32, 32, 160, 288, 360],
                                  [0, 3, 360]],
                         ids=["one", "two", "ragged", "tiny-first"])
def test_fixed_chunkings_match_jax_and_oneshot(opt, cuts):
    _assert_stream_equals_oneshot(_dataset(0, n=288), cuts, **opt)


def test_duplicate_and_dominated_chunks():
    """A chunk of strictly dominated rows changes nothing but ``seen``;
    duplicates of members join the front and evict nobody."""
    x = _dataset(3, n=200)[:200]
    both = Both(4)
    both.insert(x, step=0)
    base = both.snapshot()
    stats = both.insert(np.clip(x[:50] + 0.3, 0.0, 1.3), step=1)
    assert int(stats["evicted"]) == 0 and int(stats["inserted"]) == 0
    assert int(stats["chunk_arrivals"]) == 50 and int(stats["n_valid"]) == 0
    _eq(both.snapshot().points, base.points.numpy())
    assert int(both.t.seen) == 250
    stats = both.insert(x[:20], step=2)
    assert int(stats["evicted"]) == 0
    assert int(both.t.count) > int(base.count)


def test_masked_and_empty_chunks():
    x = _dataset(5, n=160)
    half = x.shape[0] // 2
    both = Both(4)
    both.insert(x[:half], step=0)
    both.insert(np.ones((32, 4), np.float32), np.zeros(32, bool), step=1)
    both.insert(x[half:], step=2)
    part = np.array([True, False] * 3 + [True])
    both.insert(x[:7], part, step=3)          # masked duplicates
    out = both.snapshot()
    one, _ = tapi.parallel_skyline(np.concatenate([x, x[:7][part]]),
                                   cfg=both.tcfg, device="cpu")
    for g, w in zip(out, one):
        _eq(g, w.numpy(), "one-shot")
    assert int(both.t.seen) == x.shape[0] + 4


def test_overflowing_state():
    x = _dataset(6, n=600)
    both = Both(4, capacity=40, block=16)
    for i, c0 in enumerate(range(0, x.shape[0], 150)):
        both.insert(x[c0:c0 + 150], step=i)
    assert bool(both.t.overflow)
    both.snapshot()


@pytest.mark.parametrize("opt", [{}, dict(rep_filter="sorted", noseq=True)],
                         ids=["sliced", "sliced+noseq+rep"])
def test_batched_insert_matches_jax_and_single_inserts(opt):
    """Q states in one batched insert: bitwise the reference's batched
    insert after every step, and each stream bitwise its own single
    insert."""
    q, d = 3, 4
    data = [_dataset(10 + i, n=160) for i in range(q)]
    both = Both(d, q=q, capacity=256, **opt)
    for step, (c0, c1) in enumerate([(0, 96), (96, 150), (150, 200)]):
        mask = np.ones((q, c1 - c0), bool)
        mask[1, ::3] = False
        both.insert(np.stack([x[c0:c1] for x in data]), mask, step=step)
    snaps = both.snapshot()
    for i in range(q):
        single = Both(d, capacity=256, **opt)
        for step, (c0, c1) in enumerate([(0, 96), (96, 150), (150, 200)]):
            mask = np.ones(c1 - c0, bool)
            if i == 1:
                mask[::3] = False
            single.insert(data[i][c0:c1], mask, step=step)
        snap = single.snapshot()
        for g, w in zip(snaps, snap):
            _eq(g[i], w.numpy(), f"stream {i}")


def test_state_carries_across_packages():
    """A JAX state after two reference inserts, carried into the port,
    takes a third insert to the same bits in both packages."""
    x = _dataset(7)
    both = Both(4)
    both.insert(x[:100], step=0)
    both.insert(x[100:220], step=1)
    leaves = [np.asarray(v) for v in both.j]
    both.t = convert.state_from_numpy(leaves, device="cpu")
    for g, w in zip(convert.state_to_numpy(both.t), leaves):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    both.insert(x[220:], step=2)
    both.snapshot()
    # batched states cross too
    qs = jinc.init_state(both.jcfg, 4, q=2)
    back = convert.state_to_numpy(convert.state_from_numpy(
        [np.asarray(v) for v in qs], device="cpu"))
    for g, w in zip(back, qs):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@settings(max_examples=6, deadline=None, database=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_property_random_chunking_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = _dataset(int(rng.integers(100)), n=256)
    n = x.shape[0]
    k = int(rng.integers(0, 6))
    cuts = [0] + sorted(rng.choice(np.arange(1, n), size=k,
                                   replace=False).tolist()) + [n]
    _assert_stream_equals_oneshot(x, cuts, noseq=bool(rng.integers(2)))


STRATEGY_OPTS = {"sequential": {}, "noseq": dict(noseq=True),
                 "sorted": dict(rep_filter="sorted")}


@pytest.mark.parametrize("merge", ["flat", "tree"])
@pytest.mark.parametrize("opt", list(STRATEGY_OPTS))
@pytest.mark.parametrize("strategy", ["random", "grid", "angular"])
def test_two_inserts_per_strategy_match_jax(strategy, opt, merge,
                                            monkeypatch):
    """Two streaming inserts under every strategy: every leaf and stat
    after each, the random strategy given the reference's ids for each
    insert's key (contract 5), and the snapshot is the one-shot answer."""
    from test_torch_parallel import feed_reference_random_ids
    keys = [jax.random.fold_in(jax.random.PRNGKey(42), s) for s in (0, 1)]
    left = feed_reference_random_ids(monkeypatch, keys)
    x = _dataset(20, n=200)[:200]
    both = Both(4, strategy=strategy, p=8, m=2, bucket_factor=8.0,
                rep_k=8, merge=merge, **STRATEGY_OPTS[opt])
    both.insert(x[:90], step=0)
    both.insert(x[90:], step=1)
    assert len(left) == (0 if strategy == "random" else 2)
    out = both.snapshot()
    one, _ = tapi.parallel_skyline(x, cfg=tapi.SkyConfig(capacity=512),
                                   device="cpu")
    for g, w in zip(out, one):
        _eq(g, w.numpy(), "one-shot")
