"""The port's admission scheduling against the JAX scheduler.

Case for case the counterpart of ``tests/test_scheduler.py``: the
second-layer backfill of `StreamingAdmitter` and the aging fronts of
`WindowedAdmitter`, each run beside ``repro.serve.scheduler`` on the same
requests (engines on the CPU, the reference with ``impl='perpair'``);
plus `admit` / `admit_many`, whose fronts and admitted indices must be
the reference's.  Tolerance: zero (rows through their int32 bits).
"""

import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import parallel as jpar
from repro.serve import engine as jeng
from repro.serve import scheduler as jsched
from repro_torch import convert
from repro_torch.serve import engine as teng
from repro_torch.serve import scheduler as tsched


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends: each
    keeps memory mappings of its machine code, and a test worker that
    runs several such modules would reach the kernel's map limit
    (vm.max_map_count), where XLA's next compile crashes the worker."""
    yield
    jax.clear_caches()
    gc.collect()


def _engines():
    jcfg = jpar.SkyConfig(strategy="sliced", p=4, capacity=256, block=64,
                          bucket_factor=6.0, impl="perpair")
    tcfg = convert.config_from_reference(
        dict(dataclasses.asdict(jcfg), impl="auto"))
    return (jeng.SkylineEngine(jcfg, min_n_bucket=64),
            teng.SkylineEngine(tcfg, min_n_bucket=64, device="cpu"))


def _requests(rows: np.ndarray):
    rows = np.asarray(rows, np.float32)
    cols = (rows[:, 0], rows[:, 1], rows[:, 2])
    return (jsched.Request(*(jnp.asarray(c) for c in cols)),
            tsched.Request(*cols))


def _sky_rows(rows: np.ndarray) -> set:
    keep = []
    for t in rows:
        dominated = any(np.all(s <= t) and np.any(s < t) for s in rows)
        if not dominated:
            keep.append(tuple(t))
    return set(keep)


def _same_rows(got, want):
    """Lists of (F_i, 3) row arrays, bit for bit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g).view(np.int32),
                                      np.asarray(w).view(np.int32))


class Admitters:
    """One admitter in each package, offered the same arrivals."""

    def __init__(self, kind, **kw):
        je, te = _engines()
        self.engine = te
        self.j = getattr(jsched, kind)(engine=je, **kw)
        self.t = getattr(tsched, kind)(engine=te, **kw)

    def offer(self, rows_per_queue):
        pairs = [None if r is None else _requests(r)
                 for r in rows_per_queue]
        self.j.offer([None if p is None else p[0] for p in pairs])
        self.t.offer([None if p is None else p[1] for p in pairs])

    def check(self):
        _same_rows(self.t.fronts(), self.j.fronts())
        if getattr(self.t, "backfill", False):
            _same_rows(self.t.second_layer_fronts(),
                       self.j.second_layer_fronts())
        return self.t.fronts()


def test_second_layer_is_skyline_of_non_front_pool():
    """After arbitrary offers (rejections AND evictions), the shadow
    front equals SKY(pool \\ front) computed from scratch, and both
    layers are the JAX admitter's."""
    rng = np.random.default_rng(0)
    adm = Admitters("StreamingAdmitter", queues=1, backfill=True)
    pool = []
    for wave in range(4):
        rows = rng.random((12, 3)).astype(np.float32)
        if wave == 2:
            rows[:4] *= 0.1     # a dominating wave that evicts members
        pool.append(rows)
        adm.offer([rows])
        adm.check()
    allrows = np.concatenate(pool)
    front = {tuple(r) for r in adm.t.fronts()[0]}
    assert front == _sky_rows(allrows)
    non_front = np.asarray([r for r in allrows if tuple(r) not in front],
                           np.float32)
    got_l2 = {tuple(r) for r in adm.t.second_layer_fronts()[0]}
    assert got_l2 == _sky_rows(non_front)


def test_admit_backfills_short_batches_from_second_layer():
    """A tiny front and a big batch size: admit() tops the batch up with
    second-layer rows, as the JAX admitter does."""
    adm = Admitters("StreamingAdmitter", queues=2, backfill=True)
    rng = np.random.default_rng(1)
    dom = np.full((1, 3), 0.001, np.float32)
    rest = (rng.random((20, 3)) * 0.5 + 0.4).astype(np.float32)
    for rows in (dom, rest):
        adm.offer([rows] * 2)
    fronts = adm.check()
    assert all(f.shape[0] == 1 for f in fronts)
    batches = adm.t.admit(6)
    _same_rows(batches, adm.j.admit(6))
    for batch, front in zip(batches, fronts):
        assert batch.shape[0] == 6
        np.testing.assert_array_equal(batch[0], front[0])
        l2 = _sky_rows(rest)
        assert all(tuple(r) in l2 for r in batch[1:])
    plain = Admitters("StreamingAdmitter", queues=1)
    plain.offer([dom])
    plain.offer([rest])
    assert plain.t.admit(6)[0].shape[0] == 1
    _same_rows(plain.t.admit(6), plain.j.admit(6))


def test_windowed_admitter_fronts_age_out():
    """Requests only count toward the front for window_epochs ticks; an
    expired dominating wave un-dominates the survivors it suppressed."""
    adm = Admitters("WindowedAdmitter", queues=1, window_epochs=2)
    dominating = np.full((4, 3), 0.01, np.float32)
    weak = (np.random.default_rng(2).random((8, 3)) * 0.5 + 0.4
            ).astype(np.float32)
    adm.offer([dominating])
    assert adm.t.tick() == adm.j.tick()
    adm.offer([weak])
    front = adm.check()[0]
    assert {tuple(r) for r in front} == _sky_rows(dominating)
    expired = adm.t.tick()
    assert expired and adm.j.tick()
    front = adm.check()[0]
    assert {tuple(r) for r in front} == _sky_rows(weak)
    batch = adm.t.admit(3)[0]
    _same_rows([batch], adm.j.admit(3))
    assert batch.shape[0] == 3
    adm.t.tick()
    adm.j.tick()
    assert adm.check()[0].shape[0] == 0
    assert adm.t.admit(3)[0].shape[0] == 0


def test_windowed_admitter_multi_queue_single_wave():
    adm = Admitters("WindowedAdmitter", queues=3, window_epochs=2)
    eng = adm.engine
    rng = np.random.default_rng(3)
    before = eng.batches_dispatched
    adm.offer([rng.random((6, 3)).astype(np.float32) for _ in range(3)])
    assert eng.batches_dispatched - before == 1   # one feed for 3 queues
    before = eng.batches_dispatched
    adm.t.tick()
    adm.j.tick()
    assert eng.batches_dispatched - before == 1   # one tick for 3 queues
    assert all(f.shape[0] >= 1 for f in adm.check())


@pytest.mark.parametrize("batch_size", [1, 5, 40])
def test_admit_and_admit_many_indices_match_jax(batch_size):
    """`admit` / `admit_many`: fronts and admitted indices (int32) the
    reference's, with ties, duplicate rows and -0.0 in the criteria."""
    je, te = _engines()
    rng = np.random.default_rng(batch_size)
    raw = []
    for n in (30, 30, 70, 12):
        rows = np.stack([rng.integers(0, 5, n) * 1.5,
                         -rng.integers(0, 3, n).astype(np.float64),
                         rng.integers(8, 12, n)], axis=1).astype(np.float32)
        rows[::9, 1] = -0.0
        rows[5] = rows[2]
        raw.append(rows)
    pairs = [_requests(r) for r in raw]
    many = tsched.admit_many([p[1] for p in pairs], batch_size, engine=te)
    jmany = jsched.admit_many([p[0] for p in pairs], batch_size, engine=je)
    for (jr, tr), (idx, front), (jidx, jfront) in zip(pairs, many, jmany):
        np.testing.assert_array_equal(front.numpy(), np.asarray(jfront))
        assert idx.dtype == torch.int32
        assert np.asarray(jidx).dtype == np.int32
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        one_idx, one_front = tsched.admit(tr, batch_size, engine=te)
        np.testing.assert_array_equal(one_idx.numpy(), idx.numpy())
        np.testing.assert_array_equal(one_front.numpy(), front.numpy())
