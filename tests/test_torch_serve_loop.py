"""The port's serve loop (``repro_torch.serve.loop``) on a CPU engine.

Case for case the counterpart of the ServeLoop tests of
``tests/test_serve_loop.py``: every ticket of
``ServeLoop(SkylineEngine(cfg, device="cpu"))`` resolves to bit for bit
what a synchronous ``submit`` of the same request returns, coalesced
feed waves equal serial feeds, and admission sheds, degrades and orders
with exact accounting.  One more case runs the same requests and feeds
through the JAX package's ``ServeLoop`` (``impl='perpair'``) and the
port's in one process.  Tolerance: zero; f32 leaves through their int32
bits.  Where the reference test draws a chunk with ``generate(...,
jax.random key)``, the port is fed the reference's array (ROADMAP.md,
contract 5).  Every wait is bounded (``Ticket.wait(timeout=60)``, and
``drain`` on a daemon thread joined within 60 s); the loop's threads
are daemons.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses
import gc
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import parallel as jpar
from repro.core.datagen import generate
from repro.serve import engine as jeng
from repro.serve import loop as jloop
from repro.serve.api import SkylineRequest as JRequest
from repro.serve.api import StreamOptions as JOptions
from repro_torch import convert
from repro_torch.core.parallel import SkyConfig
from repro_torch.serve import engine as teng
from repro_torch.serve.api import SkylineRequest, StreamOptions
from repro_torch.serve.loop import ServeLoop, Ticket

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


CFG = dict(strategy="sliced", p=4, capacity=128, block=64,
           bucket_factor=6.0)


def _engine(**kw):
    return teng.SkylineEngine(SkyConfig(**CFG), min_n_bucket=64,
                              device="cpu", **kw)


def _gen(kind, key, n, d):
    """The reference's chunk, as a numpy array."""
    return np.asarray(generate(kind, key, n, d))


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_buffers_equal(got, want, ctx=""):
    for name, a, b in zip(("points", "mask", "count", "overflow"), got,
                          want):
        np.testing.assert_array_equal(_bits(a), _bits(b),
                                      err_msg=f"{name} {ctx}")


def _assert_results_equal(got, want):
    assert len(got) == len(want)
    for i, ((b1, _), (b2, _)) in enumerate(zip(got, want)):
        _assert_buffers_equal(b1, b2, f"result {i}")


def _drain(loop):
    """``loop.drain()``, bounded: the wait runs on a daemon thread."""
    waiter = threading.Thread(target=loop.drain, daemon=True)
    waiter.start()
    waiter.join(WAIT_S)
    assert not waiter.is_alive(), "serve loop not drained in time"


# --------------------------------------------------------------------------
# the serve loop
# --------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2])
def test_loop_answers_queries_bit_exact(depth):
    """Every ticket resolves to exactly what a synchronous submit of
    the same request returns, with or without dispatch-ahead."""
    engine = _engine()
    rng = np.random.default_rng(2)
    reqs = [SkylineRequest(data=np.asarray(rng.random((n, 3)), np.float32))
            for n in (30, 64, 10, 50)]
    with ServeLoop(engine, depth=depth, max_wave=2) as loop:
        tickets = [loop.submit(r) for r in reqs]
        _drain(loop)
    assert all(t.status == "ok" for t in tickets)
    assert all(t.latency is not None and t.latency >= 0 for t in tickets)
    assert loop.stats["completed"] == len(reqs)
    fresh = _engine()
    want = [fresh.submit(r) for r in reqs]
    _assert_results_equal([t.result for t in tickets], want)


def test_coalesced_feed_wave_equals_serial_feeds():
    """Feeds for same-bucket streams fuse into one wave dispatch and
    stay bit-for-bit equal to feeding each stream serially."""
    engine = _engine()
    k = jax.random.PRNGKey(3)
    chunks = [_gen("uniform", jax.random.fold_in(k, i), 48, 3)
              for i in range(5)]
    sa = engine.open_stream(3, StreamOptions(q=2))
    sb = engine.open_stream(3, StreamOptions(q=3))
    with ServeLoop(engine, depth=1) as loop:
        ta = loop.feed(sa, chunks[:2])
        tb = loop.feed(sb, chunks[2:])
        _drain(loop)
    assert ta.status == tb.status == "ok"
    assert loop.stats["coalesced_feeds"] >= 1
    ref = _engine()
    ra = ref.open_stream(3, StreamOptions(q=2))
    rb = ref.open_stream(3, StreamOptions(q=3))
    ra.feed(chunks[:2])
    rb.feed(chunks[2:])
    for s, r in ((sa, ra), (sb, rb)):
        for b1, b2 in zip(s.snapshot(), r.snapshot()):
            _assert_buffers_equal(b1, b2)


def test_two_feeds_of_one_stream_in_one_wave_equal_serial_feeds():
    """A wave holding two feeds of one stream (and one of another)
    dispatches them in rounds, in order: bit for bit the serial feeds,
    every row absorbed.  (The reference's loop fuses them into one
    `_wave_feed`, which keeps only one of the chunks.)  No threads: the
    wave is staged directly."""
    engine = _engine()
    rng = np.random.default_rng(15)
    chunks = [np.asarray(rng.random((60, 3)), np.float32) for _ in range(3)]
    sa = engine.open_stream(3, StreamOptions(q=1))
    sb = engine.open_stream(3, StreamOptions(q=1))
    loop = ServeLoop(engine)
    wave = loop._stage_once([
        Ticket("feed", stream=s, chunks=[c], masks=[None])
        for s, c in ((sa, chunks[0]), (sb, chunks[2]), (sa, chunks[1]))])
    assert wave.event is None  # a CPU engine's wave is done when staged
    assert loop.stats["coalesced_feeds"] == 1
    assert [int(t.result["chunk_arrivals"].sum())
            for t in wave.tickets] == [60, 60, 60]
    assert int(sa.counters()["seen"][0]) == 120
    ref = _engine()
    ra = ref.open_stream(3, StreamOptions(q=1))
    rb = ref.open_stream(3, StreamOptions(q=1))
    ra.feed([chunks[0]])
    rb.feed([chunks[2]])
    ra.feed([chunks[1]])
    for s, r in ((sa, ra), (sb, rb)):
        _assert_buffers_equal(s.snapshot()[0], r.snapshot()[0])


def test_adversarial_schedule_overflow_feeds_and_queries():
    """Interleaved overflowing feeds and queries under dispatch-ahead:
    promotion rides the pending-record path (no blocking settle) and
    every result stays exact."""
    engine = _engine()
    rng = np.random.default_rng(4)
    s = engine.open_stream(2, StreamOptions(q=1))
    big = [_gen("uniform", jax.random.fold_in(jax.random.PRNGKey(5), i),
                200, 2) for i in range(3)]
    qreqs = [SkylineRequest(data=np.asarray(rng.random((40, 3)),
                                            np.float32))
             for _ in range(3)]
    with ServeLoop(engine, depth=2, max_wave=1) as loop:
        tickets = []
        for chunk, qr in zip(big, qreqs):
            tickets.append(loop.feed(s, [chunk]))
            tickets.append(loop.submit(qr))
        _drain(loop)
    assert all(t.status == "ok" for t in tickets)
    assert not loop._watch  # close settles what the idle poll left
    buf, = s.snapshot()
    ref = _engine()
    rs = ref.open_stream(2, StreamOptions(q=1))
    for chunk in big:
        rs.feed([chunk])
    rbuf, = rs.snapshot()
    _assert_buffers_equal(buf, rbuf)
    _assert_results_equal([t.result for t in tickets[1::2]],
                          [_engine().submit(r) for r in qreqs])


def test_feed_ticket_carries_wave_stats():
    engine = _engine()
    s = engine.open_stream(3, StreamOptions(q=1))
    chunk = _gen("uniform", jax.random.PRNGKey(6), 32, 3)
    with ServeLoop(engine) as loop:
        t = loop.feed(s, [chunk]).wait(timeout=WAIT_S)
    assert t.status == "ok"
    assert int(t.result["chunk_arrivals"].sum()) == 32


# --------------------------------------------------------------------------
# deadline admission: shed + degrade accounting
# --------------------------------------------------------------------------

def test_expired_deadline_is_shed_with_accounting():
    engine = _engine()
    data = np.asarray(np.random.default_rng(7).random((32, 3)),
                      np.float32)
    with ServeLoop(engine) as loop:
        now = loop._clock()
        doomed = loop.submit(SkylineRequest(data=data, deadline=now - 1))
        ok = loop.submit(SkylineRequest(data=data))
        doomed.wait(timeout=WAIT_S)
        ok.wait(timeout=WAIT_S)
        _drain(loop)
    assert doomed.status == "shed" and doomed.result is None
    assert ok.status == "ok"
    assert loop.stats["shed"] == 1
    assert loop.stats["completed"] == 1


@pytest.mark.parametrize("as_tensor", [False, True],
                         ids=["numpy", "tensor"])
def test_degrade_answers_on_subsampled_data(as_tensor):
    """A degraded query is answered on every other row, sliced where the
    data lies (a tensor stays a tensor: no read to the host)."""
    engine = _engine()
    data = np.asarray(np.random.default_rng(8).random((64, 3)),
                      np.float32)
    mask = np.random.default_rng(9).random(64) > 0.2
    x, m = ((torch.from_numpy(data), torch.from_numpy(mask)) if as_tensor
            else (data, mask))
    with ServeLoop(engine, degrade=True) as loop:
        now = loop._clock()
        t = loop.submit(SkylineRequest(data=x, mask=m, deadline=now - 1))
        t.wait(timeout=WAIT_S)
    assert t.status == "ok" and t.degraded
    assert loop.stats["degraded"] == 1 and loop.stats["shed"] == 0
    assert isinstance(t.request.data, type(x))
    want = _engine().submit(SkylineRequest(data=data[::2], mask=mask[::2]))
    _assert_results_equal([t.result], [want])


def test_overload_sheds_oldest_deadline_first():
    """Deterministic unit test of the admission policy: backlog above
    max_queue sheds oldest-deadline-first, keeps undated items, and
    admits earliest-deadline-first (no threads involved)."""
    engine = _engine()
    loop = ServeLoop(engine, max_wave=4, max_queue=2,
                     clock=lambda: 100.0)
    loop._started = True  # enqueue without running the threads
    data = np.zeros((4, 2), np.float32)
    t200 = loop.submit(SkylineRequest(data=data, deadline=200.0))
    t150 = loop.submit(SkylineRequest(data=data, deadline=150.0))
    t300 = loop.submit(SkylineRequest(data=data, deadline=300.0))
    tnone = loop.submit(SkylineRequest(data=data))
    t250 = loop.submit(SkylineRequest(data=data, deadline=250.0))
    with loop._lock:
        batch = loop._admit_locked()
    assert [t.status for t in (t150, t200, t250)] == ["shed"] * 3
    assert all(t.done() for t in (t150, t200, t250))
    assert loop.stats["shed"] == 3
    assert batch == [t300, tnone]
    assert not loop._queue


def test_enqueue_requires_running_loop_and_close_flushes():
    engine = _engine()
    loop = ServeLoop(engine)
    with pytest.raises(RuntimeError, match="not running"):
        loop.submit(SkylineRequest(data=np.zeros((4, 2), np.float32)))
    loop.start_serving()
    t = loop.submit(SkylineRequest(
        data=np.asarray(np.random.default_rng(9).random((16, 2)),
                        np.float32)))
    loop.close()
    assert t.done() and t.status == "ok"
    assert not loop._stager.is_alive() and not loop._completer.is_alive()


def test_snapshot_never_blocks_on_inflight_wave(monkeypatch):
    """An overflowing feed's fits vector may still be in flight when the
    next operation lands: the overlayed snapshot answers exactly without
    a blocking resolve.  On the CPU a record is ready at once, so the
    poll is made to answer "not yet"."""
    monkeypatch.setattr(teng._WaveRecord, "ready", lambda self: False)
    engine = _engine()
    s = engine.open_stream(2, StreamOptions(q=1))
    chunk = _gen("uniform", jax.random.PRNGKey(10), 400, 2)
    s.feed([chunk])  # certainly overflows rows=64 slots
    assert s._pendings
    buf, = s.snapshot()  # overlay path; no drain first
    assert int(buf.mask.sum()) > 0
    over = _bits(buf.points)[buf.mask.numpy()]
    s.drain()
    assert not s._pendings
    buf2, = s.snapshot()
    settled = _bits(buf2.points)[buf2.mask.numpy()]
    np.testing.assert_array_equal(np.sort(over, axis=0),
                                  np.sort(settled, axis=0))


# --------------------------------------------------------------------------
# wave-time model: the per-(d, dtype, rows-bucket) EWMA table
# --------------------------------------------------------------------------

def test_per_bucket_ewma_model_seeds_and_learns():
    """Calibration hints seed the table before any wave runs, completed
    waves update exactly the buckets they carried, and unseen buckets
    fall back to the catch-all scalar.  numpy and torch dtypes key
    alike."""
    engine = _engine()
    seeded = (3, "float32", 64)  # the bucket the query below lands in
    engine.wave_time_hints = {seeded: 0.125}
    loop = ServeLoop(engine)
    assert loop._wave_time(seeded) == 0.125
    assert loop._wave_time((9, "float32", 64)) == 0.0  # cold, no scalar
    data = np.asarray(np.random.default_rng(12).random((40, 3)),
                      np.float32)
    s = engine.open_stream(3, StreamOptions(q=1))
    chunk = _gen("uniform", jax.random.PRNGKey(13), 32, 3)
    with loop:
        loop.submit(SkylineRequest(data=data)).wait(timeout=WAIT_S)
        loop.feed(s, [chunk]).wait(timeout=WAIT_S)
        _drain(loop)
    assert loop._ewma_tab[seeded] != 0.125
    assert loop._ewma_tab[(s.d, "float32", s.rows)] > 0.0
    assert loop._wave_time((9, "float32", 64)) == loop._ewma > 0.0
    # a tensor query keys alike
    assert loop._model_key(Ticket("query", request=SkylineRequest(
        data=torch.from_numpy(data)))) == seeded


def test_seeded_bucket_model_drives_admission():
    """Deterministic unit test: a calibration-seeded wave time for one
    bucket sheds exactly the requests that bucket's model says cannot
    meet their deadline (no threads involved)."""
    engine = _engine()
    engine.wave_time_hints = {(2, "float32", 64): 50.0}
    loop = ServeLoop(engine, clock=lambda: 100.0)
    loop._started = True  # enqueue without running the threads
    data = np.zeros((10, 2), np.float32)
    doomed = loop.submit(SkylineRequest(data=data, deadline=110.0))
    kept = loop.submit(SkylineRequest(data=data, deadline=200.0))
    with loop._lock:
        batch = loop._admit_locked()
    assert doomed.status == "shed" and loop.stats["shed"] == 1
    assert batch == [kept] and kept.status == "pending"


def test_concurrent_submitters_all_resolve():
    """Many intake threads racing one staging thread, with a short
    thread switch interval: every ticket resolves exactly once, to the
    synchronous answer, and the completed count loses no update."""
    engine = _engine()
    rng = np.random.default_rng(11)
    datas = [np.asarray(rng.random((24, 3)), np.float32)
             for _ in range(24)]
    tickets = []
    tlock = threading.Lock()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ServeLoop(engine, depth=2, max_wave=3) as loop:
            def pump(xs):
                for x in xs:
                    t = loop.submit(SkylineRequest(data=x))
                    with tlock:
                        tickets.append(t)
            threads = [threading.Thread(target=pump, args=(datas[i::8],))
                       for i in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=WAIT_S)
                assert not th.is_alive()
            _drain(loop)
    finally:
        sys.setswitchinterval(interval)
    assert len(tickets) == len(datas)
    assert all(t.status == "ok" for t in tickets)
    assert loop.stats["completed"] == len(datas)
    fresh = _engine()
    _assert_results_equal(
        [t.result for t in tickets],
        [fresh.submit(t.request) for t in tickets])


def test_failed_wave_resolves_its_tickets_and_the_loop_goes_on(
        monkeypatch):
    """A wave that raises while staging resolves its tickets to "error"
    with the exception; the next wave is served."""
    engine = _engine()
    data = np.asarray(np.random.default_rng(14).random((16, 2)),
                      np.float32)
    calls = []
    orig = engine.submit_many

    def flaky(reqs):
        calls.append(len(reqs))
        if len(calls) == 1:
            raise RuntimeError("boom")
        return orig(reqs)

    monkeypatch.setattr(engine, "submit_many", flaky)
    with ServeLoop(engine, depth=1) as loop:
        bad = loop.submit(SkylineRequest(data=data)).wait(timeout=WAIT_S)
        good = loop.submit(SkylineRequest(data=data)).wait(timeout=WAIT_S)
        _drain(loop)
    assert bad.status == "error" and isinstance(bad.result, RuntimeError)
    assert good.status == "ok" and loop.stats["completed"] == 1


# --------------------------------------------------------------------------
# the port's loop against the JAX package's, in one process
# --------------------------------------------------------------------------

def test_loop_matches_the_reference_loop():
    """The same sliced requests and stream feeds through the JAX
    ``ServeLoop`` and the port's: every ticket and every snapshot bit
    for bit alike (tolerance 0).  Waves of at most two items never hold
    two feeds of one stream, where the reference keeps one chunk."""
    jcfg = jpar.SkyConfig(impl="perpair", **CFG)
    tcfg = convert.config_from_reference(
        dict(dataclasses.asdict(jcfg), impl="auto"))
    je = jeng.SkylineEngine(jcfg, min_n_bucket=64)
    te = teng.SkylineEngine(tcfg, min_n_bucket=64, device="cpu")
    rng = np.random.default_rng(21)
    queries = [np.asarray(rng.random((n, 3)), np.float32)
               for n in (30, 64, 10, 50, 100)]
    chunks = [np.asarray(rng.random((n, 3)), np.float32)
              for n in (40, 120, 70, 90, 200, 30)]
    results = []
    for eng, req, opts, conv in (
            (je, JRequest, JOptions, jnp.asarray),
            (te, SkylineRequest, StreamOptions, lambda a: a)):
        loop_cls = jloop.ServeLoop if eng is je else ServeLoop
        sa = eng.open_stream(3, opts(q=2))
        sb = eng.open_stream(3, opts(q=1))
        with loop_cls(eng, depth=2, max_wave=2) as loop:
            tickets = []
            for i, x in enumerate(queries):
                tickets.append(loop.submit(req(data=conv(x))))
                if i < 3:
                    tickets.append(loop.feed(
                        sa, [conv(chunks[2 * i]), conv(chunks[2 * i + 1])]))
                    tickets.append(loop.feed(sb, [conv(chunks[5 - i])]))
            loop.drain() if eng is je else _drain(loop)
        assert all(t.status == "ok" for t in tickets)
        sa.drain()
        sb.drain()
        results.append(([t.result[0] for t in tickets if t.kind == "query"],
                        sa.snapshot() + sb.snapshot()))
    (jq, jsnap), (tq, tsnap) = results
    for i, (g, w) in enumerate(zip(tq, jq)):
        _assert_buffers_equal(g, w, f"query {i}")
    for i, (g, w) in enumerate(zip(tsnap, jsnap)):
        _assert_buffers_equal(g, w, f"snapshot {i}")
