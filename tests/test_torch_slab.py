"""The port's slab arenas and slab-backed streams against the JAX engine.

Case for case the counterpart of ``tests/test_slab.py``:
``repro_torch.serve.slab.SlabArena`` and the streams of
``repro_torch.serve.engine.SkylineEngine(..., device="cpu")`` run the
same numpy chunks as ``repro.serve`` with ``impl='perpair'`` (JAX on the
CPU).  Snapshots, counters and slot rows are compared after every step;
every leaf through its int32 bits for the sliced, grid and angular
strategies, the member set, count and overflow for the random strategy
(ROADMAP.md, contract 5).  Tolerance: zero.  The reference's
trace-count bounds become bounds on the port's pack keys and on the
sweep and dominance calls per feed.

On the CPU a wave's ``fits`` is ready at once; the deferred path (a
record the poll does not find ready, overlaid by reads and chained by
later feeds) is forced by making the poll answer "not yet".
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
from repro.serve.api import StreamOptions as JOptions
from repro_torch import convert
from repro_torch.core import sfs as tsfs
from repro_torch.core import incremental as tinc
from repro_torch.kernels.dominance import ops as dops
from repro_torch.kernels.sfs import ops as sops
from repro_torch.serve import engine as teng
from repro_torch.serve.api import StreamOptions
from repro_torch.serve.slab import SlabArena, slot_rows_bucket


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
            bucket_factor=6.0)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _anti(seed, n, d=4):
    rng = np.random.default_rng(seed)
    jit = rng.random((n, d)) - 0.5
    x = 0.5 + 0.05 * rng.standard_normal((n, 1)) \
        + 0.9 * (jit - jit.mean(axis=1, keepdims=True))
    return np.clip(x, 0.0, 1.0).astype(np.float32)


def _uniform(seed, n, d=4):
    return np.random.default_rng(seed).random((n, d)).astype(np.float32)


def _pair(min_slab_rows=64, **kw):
    cfg = dict(BASE, **kw)
    jcfg = jpar.SkyConfig(impl="perpair", **cfg)
    tcfg = convert.config_from_reference(
        dict(dataclasses.asdict(jcfg), impl="auto"))
    return (jeng.SkylineEngine(jcfg, min_n_bucket=64,
                               min_slab_rows=min_slab_rows),
            teng.SkylineEngine(tcfg, min_n_bucket=64,
                               min_slab_rows=min_slab_rows, device="cpu"))


def _open(pair, d, **opts):
    je, te = pair
    return (je.open_stream(d, JOptions(**opts)),
            te.open_stream(d, StreamOptions(**opts)))


def _feed(streams, chunks):
    js, ts = streams
    js.feed([None if c is None else jnp.asarray(c) for c in chunks])
    ts.feed(chunks)


def _sky_set(pts, mask):
    return set(map(tuple, _bits(pts)[mask].tolist()))


def assert_snapshots_equal(streams, strategy="sliced", ctx=""):
    js, ts = streams
    for j, (w, g) in enumerate(zip(js.snapshot(), ts.snapshot())):
        got = convert.buffer_to_numpy(g)
        if strategy == "random":
            assert _sky_set(got[0], got[1]) == _sky_set(
                np.asarray(w.points), np.asarray(w.mask)), (ctx, j)
            assert int(got[2]) == int(w.count), (ctx, j)
            assert bool(got[3]) == bool(w.overflow), (ctx, j)
            continue
        for a, b, name in zip(got, w, ("points", "mask", "count",
                                       "overflow")):
            np.testing.assert_array_equal(_bits(a), _bits(b),
                                          err_msg=f"{name} {ctx} {j}")


def _one_shot(te, rows):
    (buf, _), = te.submit_many([teng.SkylineRequest(data=rows)])
    return buf


def _assert_buf_equal(got, want, ctx=""):
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b), ctx


def test_slot_rows_bucket():
    assert slot_rows_bucket(1, 64, 4096) == 64
    assert slot_rows_bucket(65, 64, 4096) == 128
    assert slot_rows_bucket(4097, 64, 4096) == 4096  # clipped at capacity
    assert slot_rows_bucket(1, 64, 32) == 32         # floor above cap


def test_arena_lease_release_reuse_blanked():
    arena = SlabArena(epochs=2, rows=8, d=3, init_slots=2)
    a = arena.lease(2)
    assert arena.leased == 2
    # dirty a slot in place, release, re-lease: contents come back blank
    arena.leaves()[1][a[0]] = True      # mask leaf
    arena.leaves()[2][a[0]] = 5         # count leaf
    arena.leaves()[0][a[0]] = 0.25      # points leaf
    arena.release([a[0]])
    b = arena.lease(1)
    assert b == [a[0]]  # LIFO free list reuses the released slot
    assert not bool(arena.leaves()[1][b[0]].any())
    assert int(arena.leaves()[2][b[0]].sum()) == 0
    assert float(arena.leaves()[0][b[0]].min()) > 1e38  # sentinel-filled
    assert float(arena.leaves()[0][a[1]].min()) > 1e38  # untouched slot


def test_closed_stream_fails_fast():
    _, te = _pair(capacity=128)
    s = te.open_stream(3, StreamOptions(q=1))
    s.close()
    chunk = _uniform(0, 64, 3)
    for op in (lambda: s.feed([chunk]), s.snapshot, s.counters):
        with pytest.raises(ValueError, match="closed"):
            op()


def test_arena_double_release_rejected():
    """Releasing a slot twice (or a slot the arena never issued) raises
    instead of letting two tenants lease the same slot."""
    arena = SlabArena(epochs=1, rows=4, d=2, init_slots=4)
    a = arena.lease(2)
    arena.release([a[0]])
    with pytest.raises(ValueError):
        arena.release([a[0]])  # stale slot list
    with pytest.raises(ValueError):
        arena.release([99])    # never allocated
    assert arena.leased == 1   # accounting intact


def test_stream_takes_int_seeds_only():
    """Where the reference takes legacy and typed PRNG keys, the port
    takes an int seed, kept on the host (an idle stream holds no
    tensor); a key array is refused.  The seed never changes the
    answer."""
    _, te = _pair(capacity=128)
    chunk = _uniform(1, 64, 3)
    ref = _one_shot(te, chunk)
    for key in (None, 7, np.int64(7)):
        s = te.open_stream(3, StreamOptions(q=1, key=key))
        assert isinstance(s._seed, int)
        assert not any(isinstance(v, torch.Tensor)
                       for v in vars(s).values())
        s.feed([chunk])
        _assert_buf_equal(s.snapshot()[0], ref)
        s.close()
    with pytest.raises(ValueError, match="int seed"):
        StreamOptions(key=jax.random.PRNGKey(7))


def test_arena_growth_doubles_and_keeps_content():
    arena = SlabArena(epochs=1, rows=4, d=2, init_slots=2)
    a = arena.lease(2)
    arena.leaves()[2][a[1]] = 7
    arena.lease(5)  # forces growth past 2 slots
    assert arena.capacity >= 7
    assert arena.grows >= 1
    assert int(arena.leaves()[2][a[1]].sum()) == 7  # content survived
    assert arena.num_buffers() == 6  # growth replaced, not accumulated


def test_thousand_idle_streams_one_arena_per_bucket():
    """1000 idle tenant streams of one bucket live in ONE arena: six
    device tensors whatever the stream count; closing returns every
    slot."""
    _, te = _pair(capacity=256)
    warm = te.open_stream(3, StreamOptions(q=1, window_epochs=4))
    streams = [te.open_stream(3, StreamOptions(q=1, window_epochs=4))
               for _ in range(1000)]
    assert len(te._arenas) == 1
    (key, report), = te.arena_report().items()
    assert report["leased"] == 1001  # + the warmup stream
    assert report["slots"] >= 1001
    assert report["buffers"] == 6
    assert report["grows"] == 7      # 8 -> 16 -> ... -> 1024 slots
    assert all(s.arena is warm.arena for s in streams)
    assert not any(isinstance(v, torch.Tensor)
                   for s in streams for v in vars(s).values())
    for s in streams:
        s.close()
    assert te.arena_report()[key]["leased"] == 1
    assert te.arena_report()[key]["slots"] == report["slots"]


@pytest.mark.parametrize("strategy", ["sliced", "random"])
def test_streams_share_arena_and_feed_is_exact(strategy):
    """Two independently opened streams of one bucket lease from the
    same arena; feeding one never perturbs the other; both snapshot to
    the JAX streams' answers and to one-shot answers."""
    je, te = pair = _pair(strategy=strategy, capacity=256)
    a = _anti(0, 200)
    b = _uniform(1, 150)
    s1 = _open(pair, 4, q=1)
    s2 = _open(pair, 4, q=1)
    assert s1[1].arena is s2[1].arena
    assert set(s1[1].slots).isdisjoint(s2[1].slots)
    _feed(s1, [a[:100]])
    _feed(s2, [b])
    _feed(s1, [a[100:]])
    assert_snapshots_equal(s1, strategy)
    assert_snapshots_equal(s2, strategy)
    ra, rb = _one_shot(te, a), _one_shot(te, b)
    _assert_buf_equal(s1[1].snapshot()[0], ra)
    _assert_buf_equal(s2[1].snapshot()[0], rb)
    for k, v in s1[0].counters().items():
        np.testing.assert_array_equal(s1[1].counters()[k], np.asarray(v))


@pytest.mark.parametrize("strategy", ["sliced", "angular"])
def test_promotion_grows_rows_bucket_and_stays_exact(strategy):
    """A tenant whose front outgrows its slot is promoted to the next
    rows bucket (new arena) with nothing lost: snapshots stay the JAX
    stream's and the one-shot answer, and the old slots return to the
    free list."""
    je, te = pair = _pair(min_slab_rows=8, strategy=strategy)
    pts = _anti(3, 400)
    streams = _open(pair, 4, q=1)
    first_arena, first_rows = streams[1].arena, streams[1].rows
    assert first_rows == 8
    for lo in range(0, 400, 100):
        _feed(streams, [pts[lo:lo + 100]])
        assert_snapshots_equal(streams, strategy, lo)
    for s in streams:
        s.drain()
    assert streams[1].rows == streams[0].rows > first_rows
    assert first_arena.leased == 0   # old slots released on promotion
    assert_snapshots_equal(streams, strategy, "drained")
    buf = streams[1].snapshot()[0]
    _assert_buf_equal(buf, _one_shot(te, pts))
    assert streams[1].rows < 512     # the slot tracks the front size


@pytest.mark.parametrize("strategy", ["grid"])
def test_windowed_promotion_carries_old_epochs(strategy):
    """Promotion in a windowed stream re-pads every epoch, not just the
    freshly inserted head: older epochs survive the move bitwise."""
    je, te = pair = _pair(min_slab_rows=8, strategy=strategy)
    pts = _anti(5, 300)
    streams = _open(pair, 4, q=1, window_epochs=3)
    _feed(streams, [pts[:100]])
    for s in streams:
        s.tick()
    _feed(streams, [pts[100:300]])
    for s in streams:
        s.drain()
    assert streams[1].rows == streams[0].rows > 8
    assert_snapshots_equal(streams, strategy)
    _assert_buf_equal(streams[1].snapshot()[0], _one_shot(te, pts))


def _never_ready(monkeypatch):
    monkeypatch.setattr(teng._WaveRecord, "ready", lambda self: False)


def test_feed_defers_fits_until_the_poll_finds_it(monkeypatch):
    """No stream operation waits on the overflow check: while the poll
    finds the record not ready, `feed` keeps it pending, `snapshot`
    overlays it (bit for bit the JAX stream's), and the promotion lands
    only at the blocking `drain`."""
    je, te = pair = _pair(min_slab_rows=8)
    _never_ready(monkeypatch)
    pts = _anti(9, 200)
    streams = _open(pair, 4, q=1)
    _feed(streams, [pts])
    ts = streams[1]
    assert ts.rows == 8 and len(ts._pendings) == 1
    assert_snapshots_equal(streams)
    assert ts.poll() is True and ts.rows == 8      # still pending
    ts.drain()                                     # the sanctioned settle
    streams[0].drain()
    assert not ts._pendings and ts.rows == streams[0].rows > 8
    assert_snapshots_equal(streams)
    _assert_buf_equal(ts.snapshot()[0], _one_shot(te, pts))


@pytest.mark.parametrize("windowed", [False, True])
def test_chained_pending_records_equal_settled_ones(windowed, monkeypatch):
    """Several unresolved records at once (feeds chained on overflowing
    feeds, ticks parking records at other epochs): snapshots and
    counters equal a stream that settled every record at once."""
    opts = dict(q=3, window_epochs=3 if windowed else None)
    te_a = _pair(min_slab_rows=8)[1]
    te_b = _pair(min_slab_rows=8)[1]
    settled = te_a.open_stream(4, StreamOptions(**opts))
    deferred = te_b.open_stream(4, StreamOptions(**opts))
    rng = np.random.default_rng(4)
    _never_ready(monkeypatch)
    for w in range(6):
        chunks = [None if rng.random() < 0.2 else
                  _anti(100 * w + t, int(rng.integers(1, 90)))
                  for t in range(3)]
        settled.feed(chunks)
        settled.drain()
        deferred.feed(chunks)
        if windowed and w % 2:
            settled.tick([0, 2] if w == 3 else None)
            deferred.tick([0, 2] if w == 3 else None)
        for g, w_ in zip(deferred.snapshot(), settled.snapshot()):
            _assert_buf_equal(g, w_, w)
        assert len(deferred._pendings) >= 1
    c1, c2 = deferred.counters(), settled.counters()
    for k in c1:
        np.testing.assert_array_equal(c1[k], c2[k])
    deferred.drain()
    assert deferred.rows == settled.rows
    for g, w_ in zip(deferred.snapshot(), settled.snapshot()):
        _assert_buf_equal(g, w_)


def test_two_stream_wave_equals_serial_feeds(monkeypatch):
    """`_wave_feed` of two streams of one bucket is bit for bit the two
    fed one by one, pending records and the random strategy's seeds
    included."""
    for strategy in ("sliced", "random"):
        te_a = _pair(min_slab_rows=8, strategy=strategy)[1]
        te_b = _pair(min_slab_rows=8, strategy=strategy)[1]
        a1, a2 = (te_a.open_stream(4, StreamOptions(q=q, key=k))
                  for q, k in ((2, 5), (3, 6)))
        b1, b2 = (te_b.open_stream(4, StreamOptions(q=q, key=k))
                  for q, k in ((2, 5), (3, 6)))
        rng = np.random.default_rng(8)
        for w in range(4):
            c1 = [_anti(10 * w + t, int(rng.integers(20, 120)))
                  for t in range(2)]
            c2 = [None, _anti(50 + w, 70), _uniform(w, 30)]
            a1.feed(c1)
            a2.feed(c2)
            teng._wave_feed(te_b, [(b1, *b1._feed_args(c1, None)),
                                   (b2, *b2._feed_args(c2, None))])
            for sa, sb in ((a1, b1), (a2, b2)):
                for g, w_ in zip(sb.snapshot(), sa.snapshot()):
                    _assert_buf_equal(g, w_, (strategy, w))
                assert sa.rows == sb.rows and sa.chunks_fed == sb.chunks_fed
        if strategy == "sliced":
            for k in ("bucket_counts", "inserted", "evicted"):
                assert torch.equal(b2.last_stats[k], a2.last_stats[k])


def test_epoch_capacity_caps_slots_and_stays_exact():
    """A windowed stream with a declared epoch_capacity keeps its slot
    ceiling at the rounded epoch capacity, and snapshots stay the JAX
    stream's and the one-shot answer."""
    je, te = pair = _pair(min_slab_rows=8)
    pts = _anti(11, 120)
    streams = _open(pair, 4, q=1, window_epochs=3, epoch_capacity=100)
    assert streams[1].cap == streams[0].cap == 128
    _feed(streams, [pts[:60]])
    for s in streams:
        s.tick()
    _feed(streams, [pts[60:]])
    assert_snapshots_equal(streams)
    assert streams[1].rows <= streams[1].cap < 512
    _assert_buf_equal(streams[1].snapshot()[0], _one_shot(te, pts))
    with pytest.raises(ValueError, match="windowed"):
        te.open_stream(4, StreamOptions(q=1, epoch_capacity=100))
    with pytest.warns(DeprecationWarning, match="open_stream"):
        legacy = te.open_stream(4, q=1, window_epochs=3,
                                epoch_capacity=100)
    assert legacy.cap == 128


def test_all_idle_feed_and_all_expired_snapshot():
    """An all-idle feed (every chunk None) and an all-expired window:
    snapshots stay empty and finite, as in the JAX engine."""
    je, te = pair = _pair(capacity=256)
    streams = _open(pair, 4, q=2, window_epochs=2)
    _feed(streams, [None, None])
    assert_snapshots_equal(streams)
    for buf in streams[1].snapshot():
        assert int(buf.count) == 0 and not bool(buf.mask.any())
        assert not bool(torch.isnan(buf.points).any())
    _feed(streams, [_uniform(0, 64), None])
    for s in streams:
        s.expire_epoch()
    assert_snapshots_equal(streams)
    for buf in streams[1].snapshot():
        assert int(buf.count) == 0 and not bool(buf.mask.any())
    counters = streams[1].counters()
    assert counters["count"].tolist() == [0, 0]
    assert not counters["overflow"].any()
    for k, v in streams[0].counters().items():
        np.testing.assert_array_equal(counters[k], np.asarray(v))


def test_slab_feeds_bounded_by_bucket(monkeypatch):
    """Same-shape feeds across many streams share one pack key per
    chunk bucket, and each feed, tick and snapshot makes the same calls
    whatever the stream count or ring position: 2 sweep + 2 dominance
    calls per feed, 1 + 0 per windowed snapshot, 0 + 0 per tick."""
    _, te = _pair(capacity=128, min_slab_rows=128)
    counts = {"sweep": 0, "dom": 0}
    osweep, odom = sops.sfs_sweep, dops.dominated_mask
    monkeypatch.setattr(tsfs, "sfs_sweep", lambda *a, **k: (
        counts.__setitem__("sweep", counts["sweep"] + 1), osweep(*a, **k))[1])
    monkeypatch.setattr(tinc, "dominated_mask", lambda *a, **k: (
        counts.__setitem__("dom", counts["dom"] + 1), odom(*a, **k))[1])

    def calls(fn):
        counts.update(sweep=0, dom=0)
        fn()
        return counts["sweep"], counts["dom"]

    streams = [te.open_stream(3, StreamOptions(q=1, window_epochs=3))
               for _ in range(6)]
    before = teng.pack_trace_count()
    for step in range(4):
        for j, s in enumerate(streams):
            assert calls(lambda: s.feed([_uniform(17 * step + j, 64, 3)])) \
                == (2, 2)
            assert calls(s.snapshot) == (1, 0)
        for s in streams:
            assert calls(s.tick) == (0, 0)
    assert teng.pack_trace_count() - before <= 1


def test_state_tensors_are_written_in_place():
    """A feed, a tick and a promotion write the arena's leaves in place:
    the arena keeps the same six tensors (donation becomes in-place
    writes)."""
    _, te = _pair(min_slab_rows=8)
    s = te.open_stream(4, StreamOptions(q=2, window_epochs=2))
    ids = [id(a) for a in s.arena.leaves()]
    arena = s.arena
    s.feed([_anti(0, 20), _anti(1, 3)])
    s.tick()
    assert [id(a) for a in arena.leaves()] == ids
    s.feed([_anti(2, 300), None])
    s.drain()
    assert s.arena is not arena and arena.leased == 0
    assert [id(a) for a in arena.leaves()] == ids
