"""Donation (``SkyConfig.donate``) in the port: writes in place, same bits.

Case for case the counterpart of ``tests/test_donation.py``.  With
donation on (the default) an insert or a window operation writes the
state's own tensors and returns them; with it off the inputs are left
as they were.  The engine's slab arenas are its own and are written in
place under either setting.  Every streaming and
serving path gives the same bits either way: chunked inserts, window
ticks, advance and expiry, slab feeds, windowed slab feeds and ticks,
coalesced serve-loop waves, and chained pending overlays with promotion
mid-chain.  The reference's "a donated state is consumed" (its buffers
are deleted) becomes two checks: with donation on the returned leaves
are the input's tensors; with it off the input's bits are unchanged.  A
snapshot taken before an in-place insert keeps its bits.  Tolerance:
zero; f32 leaves through their int32 bits.  The data are the
reference's arrays (ROADMAP.md, contract 5).
"""

import gc
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.datagen import generate
from repro_torch.core import incremental as inc
from repro_torch.core import windowed as win
from repro_torch.core.parallel import SkyConfig
from repro_torch.serve import engine as teng
from repro_torch.serve.api import StreamOptions
from repro_torch.serve.engine import SkylineEngine
from repro_torch.serve.loop import ServeLoop

WAIT_S = 60


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends: each
    keeps memory mappings of its machine code, and a test worker that
    runs several such modules would reach the kernel's map limit
    (vm.max_map_count), where XLA's next compile crashes the worker."""
    yield
    jax.clear_caches()
    gc.collect()


def _cfg(donate: bool, **kw) -> SkyConfig:
    base = dict(strategy="sliced", p=4, capacity=256, block=64,
                bucket_factor=1.5, donate=donate)
    base.update(kw)
    return SkyConfig(**base)


def _dataset(seed: int, n: int = 256, d: int = 4) -> np.ndarray:
    """The reference test's data: anticorrelated rows salted with exact
    duplicates, dominated rows and single-coordinate ties."""
    pts = generate("anticorrelated", jax.random.PRNGKey(seed), n, d)
    dup = pts[: n // 8]
    dominated = jnp.clip(pts[: n // 8] + 0.25, 0.0, 1.25)
    ties = pts[n // 8: n // 4].at[:, 0].set(pts[0, 0])
    return np.asarray(jnp.concatenate([pts, dup, dominated, ties]))


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_buffers_equal(a, b):
    np.testing.assert_array_equal(_bits(a.points), _bits(b.points))
    np.testing.assert_array_equal(_bits(a.mask), _bits(b.mask))


def _assert_trees_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_bits(x), _bits(y))


def _drain(loop):
    """``loop.drain()``, bounded: the wait runs on a daemon thread."""
    waiter = threading.Thread(target=loop.drain, daemon=True)
    waiter.start()
    waiter.join(WAIT_S)
    assert not waiter.is_alive(), "serve loop not drained in time"


def _copy(tree):
    return tuple(x.clone() for x in tree)


def _ones(n):
    return torch.ones(n, dtype=torch.bool)


# --------------------------------------------------------------------------
# core: chunked insert / finalize
# --------------------------------------------------------------------------

def test_insert_finalize_bit_identical_donate_on_off():
    pts = torch.from_numpy(_dataset(0))
    outs = []
    for donate in (True, False):
        cfg = _cfg(donate)
        state = inc.init_state(cfg, pts.shape[1], device="cpu")
        for cut in range(0, pts.shape[0], 100):
            chunk = pts[cut:cut + 100]
            state, _ = inc.insert_chunk(state, chunk, _ones(len(chunk)),
                                        cfg=cfg)
        outs.append(inc.finalize(state, cfg=cfg))
    _assert_buffers_equal(outs[0], outs[1])
    _assert_trees_equal(outs[0], outs[1])


@pytest.mark.parametrize("q", [None, 2], ids=["one", "batched"])
def test_donated_insert_writes_the_input_state(q):
    """The observable half of the single-owner protocol: with donation
    on, the returned leaves are the input's own tensors (the old binding
    reads the new values); with donation off the input's bits are
    unchanged.  Both give the same bits."""
    x = torch.from_numpy(_dataset(1)[:200])
    pts = x[:100] if q is None else x.reshape(2, 100, -1)
    news = []
    for donate in (True, False):
        cfg = _cfg(donate)
        state = inc.init_state(cfg, pts.shape[-1], q=q, device="cpu")
        state, _ = inc.insert_chunk(state, pts[..., :50, :], cfg=cfg)
        before = _copy(state)
        ptrs = [leaf.data_ptr() for leaf in state]
        new, _ = inc.insert_chunk(state, pts[..., 50:, :], cfg=cfg)
        if donate:
            assert all(n is s for n, s in zip(new, state))
            assert [leaf.data_ptr() for leaf in new] == ptrs
            assert int(state.chunks.reshape(-1)[0]) == 2
        else:
            assert all(n.data_ptr() != s.data_ptr()
                       for n, s in zip(new, state))
            _assert_trees_equal(state, before)
        news.append(_copy(new))
    _assert_trees_equal(news[0], news[1])


def test_snapshot_taken_before_an_in_place_insert_keeps_its_bits():
    """No snapshot leaf aliases the state: a later donated insert, a
    window insert or a stream feed leaves it as it was."""
    x = torch.from_numpy(_dataset(11))
    cfg = _cfg(True)
    state = inc.init_state(cfg, 4, device="cpu")
    state, _ = inc.insert_chunk(state, x[:120], cfg=cfg)
    snap = inc.finalize(state, cfg=cfg)
    kept = _copy(snap)
    state, _ = inc.insert_chunk(state, x[120:], cfg=cfg)
    _assert_trees_equal(snap, kept)
    assert int(state.chunks) == 2 and int(snap.count) > 0

    ring = win.init_window_state(cfg, 4, epochs=2, device="cpu")
    ring, _ = win.insert_chunk(ring, x[:120], cfg=cfg)
    wsnap, counters = win.finalize(ring, cfg=cfg), win.window_counters(ring)
    wkept, ckept = _copy(wsnap), _copy(counters.values())
    ring, _ = win.advance_epoch(ring)
    ring, _ = win.insert_chunk(ring, x[120:], cfg=cfg)
    _assert_trees_equal(wsnap, wkept)
    _assert_trees_equal(counters.values(), ckept)

    engine = SkylineEngine(_cfg(True, capacity=128), min_n_bucket=64,
                           min_slab_rows=8, device="cpu")
    s = engine.open_stream(4, StreamOptions(q=1))
    s.feed([x[:100].numpy()])
    s.drain()
    ssnap, = s.snapshot()
    skept = _copy(ssnap)
    s.feed([x[100:].numpy()])
    s.drain()
    _assert_trees_equal(ssnap, skept)


# --------------------------------------------------------------------------
# core: windowed ring ticks
# --------------------------------------------------------------------------

def test_window_tick_bit_identical_donate_on_off():
    pts = torch.from_numpy(_dataset(2))
    finals, fronts = [], []
    for donate in (True, False):
        cfg = _cfg(donate)
        state = win.init_window_state(cfg, pts.shape[1], epochs=4,
                                      device="cpu")
        leaves = list(state)
        front = None
        for i, cut in enumerate(range(0, pts.shape[0], 80)):
            chunk = pts[cut:cut + 80]
            state, front, _ = win.window_tick(
                state, chunk, _ones(len(chunk)), cfg=cfg,
                advance=torch.tensor(i % 2 == 1))
        assert all((a is b) == donate for a, b in zip(state, leaves))
        finals.append(state)
        fronts.append(front)
    _assert_trees_equal(finals[0], finals[1])
    _assert_trees_equal(fronts[0], fronts[1])


def test_advance_and_expire_bit_identical_donate_on_off():
    pts = torch.from_numpy(_dataset(3)[:120])
    states = []
    for donate in (True, False):
        cfg = _cfg(donate)
        state = win.init_window_state(cfg, pts.shape[1], epochs=3,
                                      device="cpu")
        state, _ = win.insert_chunk(state, pts, _ones(len(pts)), cfg=cfg)
        before = _copy(state)
        new, _ = win.advance_epoch(state, donate=donate)
        if donate:
            assert all(a is b for a, b in zip(new, state))
        else:
            _assert_trees_equal(state, before)
        state = new
        state, _ = win.insert_chunk(state, pts[:40], _ones(40), cfg=cfg)
        before = _copy(state)
        new, _ = win.expire_epoch(state, donate=donate)
        if donate:
            assert all(a is b for a, b in zip(new, state))
        else:
            _assert_trees_equal(state, before)
        states.append(new)
    _assert_trees_equal(states[0], states[1])


# --------------------------------------------------------------------------
# serve: the arena, slab feeds, coalesced waves, chained pendings
# --------------------------------------------------------------------------

@pytest.mark.parametrize("donate", [True, False], ids=["on", "off"])
def test_engine_arena_writes_in_place_whatever_donate(donate):
    """The engine owns its arenas, so a feed, a tick, an expiry and a
    re-lease write the leased slots in place under either setting of
    ``SkyConfig.donate``: the arena keeps the same six tensors, and a
    re-leased slot comes back blank."""
    engine = SkylineEngine(_cfg(donate, capacity=128), min_n_bucket=64,
                           min_slab_rows=8, device="cpu")
    pts = _dataset(3, n=12)             # fronts fit the 8-row slots
    opts = StreamOptions(q=1, window_epochs=2)
    s = engine.open_stream(pts.shape[1], opts)
    leaves = s.arena.leaves()
    s.feed([pts[:6]])
    s.tick()
    s.feed([pts[6:]])
    s.expire_epoch()
    s.close()
    t = engine.open_stream(pts.shape[1], opts)
    assert t.arena is s.arena
    assert all(a is b for a, b in zip(t.arena.leaves(), leaves))
    buf = t.snapshot()[0]
    assert int(buf.count) == 0 and not bool(buf.mask.any())


def _snap(engine_donate: bool, drive) -> list:
    engine = SkylineEngine(_cfg(engine_donate, capacity=128),
                           min_n_bucket=64, min_slab_rows=8, device="cpu")
    return drive(engine)


def test_slab_feed_bit_identical_donate_on_off():
    pts = _dataset(4)

    def drive(engine):
        s = engine.open_stream(pts.shape[1], StreamOptions(q=1))
        s.feed([pts[:100]])
        s.feed([pts[100:250]])
        s.feed([pts[250:]])
        return s.snapshot()

    a, b = _snap(True, drive), _snap(False, drive)
    _assert_buffers_equal(a[0], b[0])


def test_windowed_slab_feed_and_tick_bit_identical():
    pts = _dataset(5)

    def drive(engine):
        s = engine.open_stream(pts.shape[1],
                               StreamOptions(q=1, window_epochs=3))
        s.feed([pts[:150]])
        s.tick()
        s.feed([pts[150:]])
        s.expire_epoch()
        return s.snapshot()

    a, b = _snap(True, drive), _snap(False, drive)
    _assert_buffers_equal(a[0], b[0])


def test_coalesced_wave_bit_identical_donate_on_off():
    pts = _dataset(6)
    chunks = [pts[i * 80:(i + 1) * 80] for i in range(4)]

    def drive(engine):
        sa = engine.open_stream(pts.shape[1], StreamOptions(q=1))
        sb = engine.open_stream(pts.shape[1], StreamOptions(q=1))
        with ServeLoop(engine, depth=1) as loop:
            loop.feed(sa, [chunks[0]])
            loop.feed(sb, [chunks[2]])
            loop.feed(sa, [chunks[1]])
            loop.feed(sb, [chunks[3]])
            _drain(loop)
        return sa.snapshot() + sb.snapshot()

    a, b = _snap(True, drive), _snap(False, drive)
    _assert_buffers_equal(a[0], b[0])
    _assert_buffers_equal(a[1], b[1])


def test_chained_pending_overlays_bit_identical(monkeypatch):
    """Repeated slot overflow chains pending records (promotion decided
    mid-chain once a deferred fits vector lands): the pending sub-states
    are shared overlays, never written in place, so the path is bit for
    bit alike with donation on and off.  On the CPU a record is ready at
    once; here each becomes ready at its third poll."""
    pts = _dataset(7, n=320)

    def ready(self):
        self.polls = getattr(self, "polls", 0) + 1
        return self.polls > 2

    monkeypatch.setattr(teng._WaveRecord, "ready", ready)

    def drive(engine):
        s = engine.open_stream(pts.shape[1], StreamOptions(q=1))
        chained = 0
        for lo in range(0, 320, 80):
            chained += bool(s._pendings)  # a live record to overlay
            s.feed([pts[lo:lo + 80]])  # overflows the 8-row slot fast
        assert chained >= 2
        out = [s.snapshot()[0]]
        s.feed([pts[:60]])             # keep feeding after promotion
        out.append(s.snapshot()[0])
        s.drain()
        out.append(s.snapshot()[0])
        return out

    a, b = _snap(True, drive), _snap(False, drive)
    for x, y in zip(a, b):
        _assert_buffers_equal(x, y)


# --------------------------------------------------------------------------
# eager pending drain (the idle poll)
# --------------------------------------------------------------------------

def test_stream_poll_drains_pendings_without_state_ops():
    engine = SkylineEngine(_cfg(True, capacity=128), min_n_bucket=64,
                           min_slab_rows=8, device="cpu")
    pts = _dataset(8)
    s = engine.open_stream(pts.shape[1], StreamOptions(q=1))
    s.feed([pts])                       # front > 8 rows: pending record
    assert s._pendings
    deadline = time.monotonic() + 30
    while s.poll() and time.monotonic() < deadline:
        time.sleep(0.001)
    assert not s._pendings
    buf = s.snapshot()[0]
    assert int(buf.mask.sum()) > 0


def test_serve_loop_idle_polling_drains_pendings():
    """After a wave leaves a stream with pending records, the staging
    thread's idle tick polls until they settle: the full-capacity
    sub-states are released without any further stream operation."""
    engine = SkylineEngine(_cfg(True, capacity=128), min_n_bucket=64,
                           min_slab_rows=8, device="cpu")
    pts = _dataset(9)
    s = engine.open_stream(pts.shape[1], StreamOptions(q=1))
    with ServeLoop(engine, depth=1) as loop:
        loop.feed(s, [pts]).wait(timeout=WAIT_S)
        deadline = time.monotonic() + 30
        while (s._pendings or loop._watch) and time.monotonic() < deadline:
            time.sleep(0.005)
        assert not s._pendings
        assert not loop._watch
