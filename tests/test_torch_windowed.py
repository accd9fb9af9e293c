"""The port's sliding windows against the JAX package, bit for bit.

``repro_torch.core.windowed`` runs the same numpy chunks as the
reference's ``insert_window_fn`` / ``insert_window_batch_fn`` /
``advance_epoch_fn`` / ``expire_epoch_fn`` / ``finalize_window_fn`` /
``window_tick_fn`` with ``impl='perpair'`` (JAX on the CPU).  After every
insert, advance and expiry every leaf of the ring (the head and active
scalars included) and every stat is compared; every snapshot is compared
with the reference's and with the port's one-shot ``parallel_skyline``
over exactly the unexpired rows.  Tolerance: zero; f32 leaves through
their int32 bits.  The random strategy is fed the reference's ids for
each insert's key (ROADMAP.md, contract 5).  The cases mirror
tests/test_windowed.py without its mesh and compile-count tests.
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

from repro.core import parallel as jpar
from repro.core import partition as jpart
from repro.core import windowed as jwin
from repro_torch import convert
from repro_torch.core import api as tapi
from repro_torch.core import partition as tpart
from repro_torch.core import windowed as twin


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends: each
    keeps memory mappings of its machine code, and a test worker that
    runs several such modules would reach the kernel's map limit
    (vm.max_map_count), where XLA's next compile crashes the worker."""
    yield
    jax.clear_caches()
    gc.collect()


BASE = dict(strategy="sliced", p=4, capacity=512, block=64,
            bucket_factor=6.0, impl="perpair", donate=False)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, f"{msg}: {got.dtype} vs {want.dtype}"
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=msg)


def _dataset(seed, n=256, d=4):
    """Anticorrelated data salted with duplicates and dominated rows, so
    chunk boundaries split identical points across epochs."""
    rng = np.random.default_rng(seed)
    jit = rng.random((n, d)) - 0.5
    x = 0.5 + 0.05 * rng.standard_normal((n, 1)) \
        + 0.9 * (jit - jit.mean(axis=1, keepdims=True))
    x = np.clip(x, 0.0, 1.0).astype(np.float32)
    return np.concatenate([x, x[:n // 8],
                           np.clip(x[:n // 8] + 0.25, 0.0, 1.25)])


class BothWindows:
    """One window (or Q) kept in both packages, compared after each op,
    beside a host model of the live epochs' rows."""

    def __init__(self, monkeypatch, d, epochs, q=None, epoch_capacity=0,
                 **cfg_kw):
        self.jcfg = jpar.SkyConfig(**dict(BASE, **cfg_kw))
        self.tcfg = convert.config_from_reference(
            dict(dataclasses.asdict(self.jcfg), impl="auto"))
        self.epochs, self.q, self.d = epochs, q, d
        self.j = jwin.init_window_state(self.jcfg, d, epochs=epochs, q=q,
                                        epoch_capacity=epoch_capacity)
        self.t = twin.init_window_state(self.tcfg, d, epochs=epochs, q=q,
                                        epoch_capacity=epoch_capacity,
                                        device="cpu")
        self.model = [[]]          # oldest..newest live epochs
        self.step = 0
        self.keys = []             # reference keys for the random ids
        own = tpart.random_part_ids

        def ids(generator, n, p, *, device=None):
            # inserts take the reference's ids; the one-shot answer,
            # which does not depend on the partition, draws its own
            if not self.keys:
                return own(generator, n, p, device=device)
            return torch.from_numpy(np.array(
                jpart.random_part_ids(self.keys.pop(0), n, p)))

        monkeypatch.setattr(tpart, "random_part_ids", ids)
        self.check("init")

    def check(self, where):
        for name, g, w in zip(twin.WindowedSkylineState._fields, self.t,
                              self.j):
            _eq(g, w, f"state.{name} at {where}")

    def _stats(self, tstats, jstats, where):
        assert set(tstats) == set(jstats), where
        for k in jstats:
            _eq(tstats[k], jstats[k], f"stat {k} at {where}")

    def insert(self, chunk, mask=None):
        chunk = np.asarray(chunk, np.float32)
        if mask is None:
            mask = np.ones(chunk.shape[:-1], bool)
        key = jax.random.fold_in(jax.random.PRNGKey(7), self.step)
        self.step += 1
        if self.q is None:
            self.keys = [key]
            self.j, jstats = jwin.insert_window_fn(self.jcfg)(
                self.j, jnp.asarray(chunk), jnp.asarray(mask), key)
        else:
            keys = jax.random.split(key, self.q)
            self.keys = list(keys)
            self.j, jstats = jwin.insert_window_batch_fn(self.jcfg)(
                self.j, jnp.asarray(chunk), jnp.asarray(mask), keys)
        self.t, tstats = twin.insert_chunk(self.t, chunk, mask,
                                           cfg=self.tcfg)
        self._stats(tstats, jstats, f"insert {self.step}")
        self.check(f"insert {self.step}")
        self.model[-1].append(chunk[mask] if self.q is None else
                              (chunk, mask))
        return tstats

    def advance(self):
        self.j, jstats = jwin.advance_epoch_fn(False)(self.j)
        self.t, tstats = twin.advance_epoch(self.t)
        self._stats(tstats, jstats, "advance")
        self.check("advance")
        self.model.append([])
        if len(self.model) > self.epochs:
            self.model.pop(0)

    def expire(self):
        self.j, jstats = jwin.expire_epoch_fn(False)(self.j)
        self.t, tstats = twin.expire_epoch(self.t)
        self._stats(tstats, jstats, "expire")
        self.check("expire")
        if len(self.model) > 1:
            self.model.pop(0)
        else:
            self.model[0] = []

    def snapshot(self):
        got = twin.finalize(self.t, cfg=self.tcfg)
        want = jwin.finalize_window_fn(self.jcfg, self.q is not None)(self.j)
        for g, w, name in zip(got, want, ("points", "mask", "count",
                                          "overflow")):
            _eq(g, w, f"snapshot {name}")
        _eq(twin.window_counters(self.t)["retained"],
            jwin.window_counters(self.j)["retained"], "counters")
        return got

    def survivors(self):
        rows = [c for epoch in self.model for c in epoch]
        return (np.concatenate(rows) if rows
                else np.zeros((0, self.d), np.float32))

    def run(self, ops):
        for op in ops:
            if op[0] == "insert":
                self.insert(op[1])
            elif op[0] == "advance":
                self.advance()
            else:
                self.expire()
        return self.assert_equals_oneshot()

    def assert_equals_oneshot(self):
        out = self.snapshot()
        rows = self.survivors()
        if rows.shape[0] == 0:
            assert int(out.count) == 0 and not bool(out.mask.any())
            assert not bool(torch.isnan(out.points).any())
            return out
        one, _ = tapi.parallel_skyline(rows, cfg=self.tcfg, device="cpu")
        for g, w, name in zip(out, one, ("points", "mask", "count",
                                         "overflow")):
            _eq(g, w.numpy(), f"one-shot {name}")
        assert not bool(out.overflow)
        return out


@pytest.mark.parametrize("cfg_kw", [
    dict(strategy="sliced"),
    dict(strategy="grid", p=16, bucket_factor=8.0, rep_filter="sorted",
         noseq=True),
    dict(strategy="random"),
], ids=["sliced", "grid+noseq+rep", "random"])
def test_fixed_schedules_match_jax_and_oneshot(cfg_kw, monkeypatch):
    pts = _dataset(0)
    c = [pts[i * 64:(i + 1) * 64] for i in range(5)]
    schedules = [
        # fill the ring without expiry
        [("insert", c[0]), ("advance",), ("insert", c[1]), ("advance",),
         ("insert", c[2])],
        # the ring wraps: epoch 0 expires, duplicates of its rows live on
        [("insert", c[0]), ("advance",), ("insert", c[1]), ("advance",),
         ("insert", c[2]), ("advance",), ("insert", c[0][:32]),
         ("insert", c[3])],
        # explicit expiry between inserts
        [("insert", c[0]), ("insert", c[1]), ("advance",), ("insert", c[2]),
         ("expire",), ("insert", c[4])],
    ]
    for ops in schedules:
        BothWindows(monkeypatch, 4, 3, **cfg_kw).run(ops)


def test_duplicates_straddling_epoch_boundary(monkeypatch):
    """The same rows in two epochs: expiring the older keeps the younger
    copies on the front."""
    pts = _dataset(3, n=128)
    dup = pts[:48]
    both = BothWindows(monkeypatch, 4, 2)
    out = both.run([("insert", pts[:96]), ("advance",), ("insert", dup),
                    ("insert", pts[96:]), ("advance",)])
    one, _ = tapi.parallel_skyline(np.concatenate([dup, pts[96:]]),
                                   cfg=both.tcfg, device="cpu")
    _eq(out.points, one.points.numpy(), "duplicates")


def test_epoch_expiring_to_empty_and_reuse(monkeypatch):
    """Expiring every epoch empties the window (count 0, no NaN), the
    active count stays clamped at 1 and the ring takes chunks again."""
    pts = _dataset(5, n=128)
    both = BothWindows(monkeypatch, 4, 3)
    both.insert(pts[:64])
    both.advance()
    both.insert(pts[64:128])
    for _ in range(4):
        both.expire()
    both.assert_equals_oneshot()
    assert int(both.t.active) == 1
    both.insert(pts[96:160])
    both.assert_equals_oneshot()


@pytest.mark.parametrize("strategy", ["random", "grid", "sliced"])
def test_score_ties_across_expiry(strategy, monkeypatch):
    """Quantised (tie-heavy) data across epoch boundaries and expiry."""
    rng = np.random.default_rng(3)
    pts = np.asarray(rng.integers(0, 6, (192, 3)) / 6.0, np.float32)
    BothWindows(monkeypatch, 3, 2, strategy=strategy,
                bucket_factor=48.0).run(
        [("insert", pts[:64]), ("advance",), ("insert", pts[:64]),
         ("insert", pts[64:128]), ("advance",), ("insert", pts[128:]),
         ("advance",)])


def test_epoch_capacity_rows_and_overflow(monkeypatch):
    """Epoch slots sized below the window capacity hold the same answer;
    an epoch front outgrowing its rows sets the overflow flag in both."""
    pts = _dataset(9, n=192)
    both = BothWindows(monkeypatch, 4, 3, epoch_capacity=64)
    assert both.t.points.shape[-2] == twin.epoch_rows(both.tcfg, 64) == 64
    both.run([("insert", pts[:48]), ("advance",), ("insert", pts[48:96])])
    small = BothWindows(monkeypatch, 4, 2, epoch_capacity=8)
    small.insert(pts[:128])
    assert bool(small.t.overflow.any())
    assert bool(small.snapshot().overflow)


@pytest.mark.parametrize("strategy", ["sliced", "grid"])
def test_noseq_merge_on_read(strategy, monkeypatch):
    """NoSeq merge-on-read tests every epoch against every other (the
    random strategy's potential dominators) whatever the strategy."""
    assert twin._merge_cfg(tapi.SkyConfig(strategy=strategy,
                                          noseq=True)).strategy == "random"
    pts = _dataset(11, n=192)
    BothWindows(monkeypatch, 4, 3, strategy=strategy, p=16,
                bucket_factor=8.0, noseq=True).run(
        [("insert", pts[:64]), ("advance",), ("insert", pts[64:128]),
         ("advance",), ("insert", pts[128:]), ("expire",)])


@pytest.mark.parametrize("ecap", [0, 64])
def test_fused_tick_equals_separate_ops_and_jax(ecap, monkeypatch):
    """``window_tick`` (rotate + insert + merge-on-read) is bitwise the
    three separate calls and the reference's ``window_tick_fn``, for
    both tick kinds, with ``advance`` a bool or a tensor."""
    pts = _dataset(9, n=192)
    both = BothWindows(monkeypatch, 4, 3, epoch_capacity=ecap)
    tick = jwin.window_tick_fn(both.jcfg)
    jfused = jwin.init_window_state(both.jcfg, 4, epochs=3,
                                    epoch_capacity=ecap)
    fused = twin.init_window_state(both.tcfg, 4, epochs=3,
                                   epoch_capacity=ecap, device="cpu")
    for t in range(4):
        chunk = pts[t * 48:(t + 1) * 48]
        key = jax.random.fold_in(jax.random.PRNGKey(7), t)
        jfused, jfront, _ = tick(jfused, jnp.asarray(chunk),
                                 jnp.ones(48, bool), key, jnp.bool_(t > 0))
        adv = torch.tensor(t > 0) if t % 2 else t > 0
        fused, front, _ = twin.window_tick(fused, chunk, cfg=both.tcfg,
                                           advance=adv)
        if t:
            both.advance()
        both.insert(chunk)
        plain = both.snapshot()
        for g, w, p in zip(front, jfront, plain):
            _eq(g, w, f"tick {t}")
            _eq(g, p.numpy(), f"tick {t} vs separate")
        for name, g, w in zip(twin.WindowedSkylineState._fields, fused,
                              jfused):
            _eq(g, w, f"tick state.{name}")
    assert not bool(front.overflow)


def test_batched_windows_match_jax_and_per_window(monkeypatch):
    """Q windows on one ring clock: bitwise the reference's batched ring
    after every op, and each window bitwise its own single ring."""
    q, n, d = 3, 96, 4
    rng = np.random.default_rng(4)
    waves = [rng.random((q, n, d)).astype(np.float32) for _ in range(3)]
    masks = [rng.random((q, n)) > 0.1 for _ in range(3)]
    both = BothWindows(monkeypatch, d, 2, q=q, capacity=256)
    singles = [twin.init_window_state(both.tcfg, d, epochs=2, device="cpu")
               for _ in range(q)]
    for w in range(3):
        both.insert(waves[w], masks[w])
        singles = [twin.insert_chunk(s, waves[w][i], masks[w][i],
                                     cfg=both.tcfg)[0]
                   for i, s in enumerate(singles)]
        if w < 2:
            both.advance()
            singles = [twin.advance_epoch(s)[0] for s in singles]
    outs = both.snapshot()
    for i in range(q):
        ref = twin.finalize(singles[i], cfg=both.tcfg)
        for g, w in zip(outs, ref):
            _eq(g[i], w.numpy(), f"window {i}")
    # epochs 1 and 2 are live (the ring of 2 expired wave 0)
    for i in range(q):
        rows = np.concatenate([waves[1][i][masks[1][i]],
                               waves[2][i][masks[2][i]]])
        one, _ = tapi.parallel_skyline(rows, cfg=both.tcfg, device="cpu")
        _eq(outs.points[i], one.points.numpy(), f"one-shot {i}")


@pytest.mark.parametrize("cfg_kw", [
    dict(strategy="sliced"),
    dict(strategy="grid", p=16, bucket_factor=8.0, rep_filter="region",
         noseq=True),
], ids=["sliced", "grid+region+noseq"])
def test_all_expired_window_has_no_nan(cfg_kw, monkeypatch):
    rng = np.random.default_rng(0)
    both = BothWindows(monkeypatch, 4, 2, capacity=256, **cfg_kw)
    both.insert(rng.random((64, 4)).astype(np.float32))
    both.expire()
    both.assert_equals_oneshot()
    both.insert(rng.random((64, 4)).astype(np.float32))
    assert int(both.assert_equals_oneshot().count) > 0


@pytest.mark.parametrize("epochs", [1, 3, 4])
def test_ring_clock_on_ints_arrays_and_tensors(epochs):
    for head in range(epochs):
        for active in range(1, epochs + 1):
            want = [np.asarray(v) for v in
                    jwin.ring_advance(jnp.int32(head), jnp.int32(active),
                                      epochs)]
            want.append(np.asarray(jwin.ring_tail(jnp.int32(head),
                                                  jnp.int32(active), epochs)))
            ints = list(twin.ring_advance(head, active, epochs)) + [
                twin.ring_tail(head, active, epochs)]
            tens = list(twin.ring_advance(torch.tensor(head, dtype=torch.int32),
                                          torch.tensor(active,
                                                       dtype=torch.int32),
                                          epochs)) + [
                twin.ring_tail(torch.tensor(head, dtype=torch.int32),
                               torch.tensor(active, dtype=torch.int32),
                               epochs)]
            for w, i, t in zip(want, ints, tens):
                assert int(w) == int(i) == int(t)
                assert isinstance(t, torch.Tensor)
    heads, actives = np.arange(epochs), np.full(epochs, epochs)
    got = twin.ring_advance(heads, actives, epochs)
    want = jwin.ring_advance(heads, actives, epochs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_window_state_crosses_packages_and_mesh_raises(monkeypatch):
    pts = _dataset(2, n=128)
    both = BothWindows(monkeypatch, 4, 3)
    both.insert(pts[:64])
    both.advance()
    leaves = [np.asarray(v) for v in both.j]
    both.t = convert.window_state_from_numpy(leaves, device="cpu")
    for g, w in zip(convert.window_state_to_numpy(both.t), leaves):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    both.insert(pts[64:])
    both.snapshot()
    for g, w in zip(twin.window_counters(both.t).values(),
                    jwin.window_counters(both.j).values()):
        _eq(g, w, "counters")
    with pytest.raises(TypeError, match="WorkerMesh"):
        twin.finalize(both.t, cfg=both.tcfg, mesh=object())
    # a real mesh (a world of one) reads the same snapshot, with no
    # collective
    from repro_torch.launch.mesh import make_worker_mesh
    on_mesh = twin.finalize(both.t, cfg=both.tcfg,
                            mesh=make_worker_mesh(device="cpu"))
    for g, w in zip(on_mesh, twin.finalize(both.t, cfg=both.tcfg)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="at least one epoch"):
        twin.init_window_state(both.tcfg, 4, epochs=0, device="cpu")


@settings(max_examples=12, deadline=None, database=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_property_random_interleavings_match_jax(seed):
    """Random insert/advance/expire interleavings (64-row chunks drawn
    with replacement, so duplicates straddle epoch boundaries): every
    leaf and stat after every op, and the snapshot is the one-shot
    skyline of the surviving rows."""
    rng = np.random.default_rng(seed)
    pts = _dataset(int(rng.integers(100)), n=192)
    with pytest.MonkeyPatch.context() as mp:
        both = BothWindows(mp, 4, int(rng.integers(2, 5)),
                           noseq=bool(rng.integers(2)))
        ops = []
        for _ in range(int(rng.integers(3, 9))):
            r = rng.random()
            if r < 0.55:
                lo = int(rng.integers(0, pts.shape[0] - 64))
                ops.append(("insert", pts[lo:lo + 64]))
            elif r < 0.85:
                ops.append(("advance",))
            else:
                ops.append(("expire",))
        both.run(ops)
