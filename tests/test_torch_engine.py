"""The port's batched query engine against the JAX engine, bit for bit.

``repro_torch.serve.engine.SkylineEngine(..., device="cpu")`` answers the
same numpy requests as ``repro.serve.engine.SkylineEngine`` with
``impl='perpair'`` (JAX on the CPU).  Case for case the counterpart of
``tests/test_engine.py``.  Compared: every leaf of each answer (points
through their int32 bits, mask, count, overflow) and every stat, for
the sliced, grid and angular strategies; for the random strategy, whose
draws torch cannot reproduce (ROADMAP.md, contract 5), the member set,
the count and the overflow flag.  Tolerance: zero.  The reference's
jit-retrace assertions become assertions on the port's pack keys and on
the number of sweep and dominance calls per bucket.
"""

import dataclasses
import gc
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import parallel as jpar
from repro.serve import engine as jeng
from repro.serve import scheduler as jsched
from repro_torch import convert
from repro_torch.core import api as tapi
from repro_torch.core import parallel as tpar
from repro_torch.core import sfs as tsfs
from repro_torch.core.dominance import flush_subnormal
from repro_torch.kernels.dominance import ops as dops
from repro_torch.kernels.sfs import ops as sops
from repro_torch.serve import engine as teng
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.api import SkylineRequest, StreamOptions


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends: each
    keeps memory mappings of its machine code, and a test worker that
    runs several such modules would reach the kernel's map limit
    (vm.max_map_count), where XLA's next compile crashes the worker."""
    yield
    jax.clear_caches()
    gc.collect()


STRATEGIES = ["random", "sliced", "grid", "angular"]
BASE = dict(p=4, capacity=512, block=64, bucket_factor=6.0)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _data(kind, n, d, seed):
    """Uniform, correlated, anticorrelated, or tie-heavy data with -0.0
    and subnormal coordinates."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        x = rng.random((n, d))
    elif kind == "correlated":
        x = 0.5 + 0.3 * (rng.random((n, 1)) - 0.5) \
            + 0.1 * (rng.random((n, d)) - 0.5)
    elif kind == "anticorrelated":
        jit = rng.random((n, d)) - 0.5
        x = 0.5 + 0.05 * rng.standard_normal((n, 1)) \
            + 0.9 * (jit - jit.mean(axis=1, keepdims=True))
    else:
        x = rng.integers(0, 4, (n, d)) / 4
        x[rng.random((n, d)) < 0.05] = -0.0
        x[rng.random((n, d)) < 0.03] = 1e-40
    return np.clip(x, -0.0, 1.0).astype(np.float32)


_ENGINES: dict = {}


def engines(strategy="sliced", **kw):
    """One (JAX, port) engine pair per configuration, shared by the
    module's tests (the JAX engine keeps its compiled programs)."""
    key = (strategy, tuple(sorted(kw.items())))
    if key not in _ENGINES:
        ekw = {k: kw.pop(k) for k in ("min_n_bucket", "min_q_bucket")
               if k in kw}
        jcfg = jpar.SkyConfig(strategy=strategy, impl="perpair",
                              **dict(BASE, **kw))
        tcfg = convert.config_from_reference(
            dict(dataclasses.asdict(jcfg), impl="auto"))
        _ENGINES[key] = (jeng.SkylineEngine(jcfg, **ekw),
                         teng.SkylineEngine(tcfg, device="cpu", **ekw))
    return _ENGINES[key]


def _sky_set(buf):
    pts = buf.points.numpy() if isinstance(buf.points, torch.Tensor) \
        else np.asarray(buf.points)
    mask = buf.mask.numpy() if isinstance(buf.mask, torch.Tensor) \
        else np.asarray(buf.mask)
    return set(map(tuple, pts[mask].view(np.int32).tolist()))


def assert_answers_equal(got, want, strategy, ctx=""):
    """Every leaf and stat bit for bit, or for the random strategy the
    member set, count and overflow."""
    assert len(got) == len(want)
    for j, ((tb, ts), (jb, js)) in enumerate(zip(got, want)):
        if strategy == "random":
            assert _sky_set(tb) == _sky_set(jb), (ctx, j)
            assert int(tb.count) == int(jb.count), (ctx, j)
            assert bool(tb.overflow) == bool(jb.overflow), (ctx, j)
            continue
        for g, w, name in zip(convert.buffer_to_numpy(tb), jb,
                              ("points", "mask", "count", "overflow")):
            np.testing.assert_array_equal(_bits(g), _bits(w),
                                          err_msg=f"{name} {ctx} {j}")
        assert set(ts) == set(js), (ctx, j)
        for k in js:
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                          err_msg=f"{k} {ctx} {j}")


SPECS = [("uniform", 100), ("anticorrelated", 180), ("correlated", 100),
         ("uniform", 250), ("ties", 90), ("anticorrelated", 200)]


def _requests(d=4, seed=0):
    queries = [_data(kind, n, d, seed + 11 * i)
               for i, (kind, n) in enumerate(SPECS)]
    masks = [None, np.arange(180) % 3 != 0, None, None,
             np.arange(90) % 2 == 0, None]
    return queries, masks


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_engine_matches_per_query(strategy):
    """Ragged sizes over two N buckets, two masked queries, explicit
    keys: the port's answers are the JAX engine's, and without overflow
    the per-query `parallel_skyline` answer."""
    je, te = engines(strategy)
    queries, masks = _requests()
    want = je.submit_many([
        jeng.SkylineRequest(data=jnp.asarray(x),
                            mask=None if m is None else jnp.asarray(m))
        for x, m in zip(queries, masks)])
    before = te.batches_dispatched
    got = te.submit_many([SkylineRequest(data=x, mask=m, key=100 + i)
                          for i, (x, m) in enumerate(zip(queries, masks))])
    assert te.batches_dispatched - before == 2   # N buckets 128, 256
    assert_answers_equal(got, want, strategy)
    for x, m, (buf, _) in zip(queries, masks, got):
        ref, _ = tapi.parallel_skyline(x, m, cfg=te.cfg, device="cpu")
        assert not bool(buf.overflow) and not bool(ref.overflow)
        for g, w in zip(buf, ref):
            assert torch.equal(g.view(torch.int32) if g.is_floating_point()
                               else g, w.view(torch.int32)
                               if w.is_floating_point() else w)


def test_engine_accepts_tensors_and_host_data_alike():
    """A query already on the engine's device is packed there, host data
    is staged: the answers do not depend on where the data came from."""
    _, te = engines()
    queries, masks = _requests(seed=3)
    host = te.submit_many([SkylineRequest(data=x, mask=m)
                           for x, m in zip(queries, masks)])
    dev = te.submit_many([
        SkylineRequest(data=torch.from_numpy(x),
                       mask=None if m is None else torch.from_numpy(m))
        for x, m in zip(queries, masks)])
    for (a, sa), (b, sb) in zip(host, dev):
        for g, w in zip(a, b):
            assert torch.equal(g, w)
        for k in sa:
            assert torch.equal(sa[k], sb[k])


@pytest.mark.parametrize("strategy", ["sliced", "grid", "angular"])
def test_engine_subspace_and_scaled_views(strategy):
    """Views bit for bit the JAX engine's; a scale view is
    `parallel_skyline` of the flushed f32 product (subnormal scales
    included), a subspace view that of the zeroed copy."""
    je, te = engines(strategy)
    pts = _data("anticorrelated", 300, 4, seed=3)
    w = np.random.default_rng(0).uniform(0.5, 2.0, (3, 4)).astype(np.float32)
    w[2, 1] = 1e-39               # a subnormal scale, flushed as XLA does
    dm = np.asarray([[True, True, False, False], [True, True, True, True],
                     [False, True, False, True]])
    umask = np.arange(300) % 5 != 0
    jpts = jnp.asarray(pts)         # one dataset object: one view group
    for kind, params in (("scale", w), ("subspace", dm)):
        for mask in (None, umask):
            jm = None if mask is None else jnp.asarray(mask)
            want = je.submit_many([
                jeng.SkylineRequest(data=jpts, mask=jm,
                                    **{kind: jnp.asarray(row)})
                for row in params])
            before = te.batches_dispatched
            got = te.submit_many([SkylineRequest(data=pts, mask=mask,
                                                 **{kind: row})
                                  for row in params])
            assert te.batches_dispatched - before == 1   # one run
            assert_answers_equal(got, want, strategy, (kind, mask is None))
            for row, (buf, _) in zip(params, got):
                x = torch.from_numpy(pts)
                view = (flush_subnormal(flush_subnormal(x)
                                        * flush_subnormal(
                                            torch.from_numpy(row)))
                        if kind == "scale"
                        else torch.where(torch.from_numpy(row), x, 0.0))
                ref, _ = tapi.parallel_skyline(view, mask, cfg=te.cfg,
                                               device="cpu")
                assert _sky_set(buf) == _sky_set(ref)
                assert int(buf.count) == int(ref.count)


def test_view_params_on_the_device_stack_without_host_reads(monkeypatch):
    """View parameter rows already on the engine's device are stacked
    there, with no read to the host; rows from the host, or a mix, are
    staged.  The bits do not depend on where the rows came from."""
    _, te = engines()
    pts = torch.from_numpy(_data("anticorrelated", 300, 4, seed=4))
    w = np.random.default_rng(2).uniform(0.5, 2.0, (3, 4)).astype(np.float32)
    dm = np.asarray([[True, False, True, True], [False, True, True, True],
                     [True, True, True, False]])
    for kind, params in (("scale", w), ("subspace", dm)):
        host = te.submit_many([SkylineRequest(data=pts, **{kind: row})
                               for row in params])
        mixed = te.submit_many([
            SkylineRequest(data=pts, **{kind: torch.from_numpy(row)
                                        if i % 2 else row})
            for i, row in enumerate(params)])
        rows = [torch.from_numpy(row) for row in params]
        with monkeypatch.context() as mp:
            mp.setattr(torch.Tensor, "numpy", lambda self, **k: pytest.fail(
                "a view parameter row was read to the host"))
            dev = te.submit_many([SkylineRequest(data=pts, **{kind: row})
                                  for row in rows])
        for other in (mixed, dev):
            for (a, sa), (b, sb) in zip(host, other):
                for g, x in zip(a, b):
                    assert torch.equal(g, x)
                for k in sa:
                    assert torch.equal(sa[k], sb[k])


def test_legacy_wrappers_warn_and_equal_submit_many():
    """`run`, `run_scaled` and `run_subspace` warn, and give the JAX
    engine's legacy answers and `submit_many`'s, bit for bit."""
    je, te = engines()
    queries, masks = _requests(seed=5)
    pts = _data("uniform", 200, 4, seed=6)
    w = np.random.default_rng(1).uniform(0.5, 2.0, (2, 4)).astype(np.float32)
    dm = np.asarray([[True, False, True, True], [True, True, False, True]])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jrun = je.run([jnp.asarray(x) for x in queries],
                      masks=[None if m is None else jnp.asarray(m)
                             for m in masks])
        jsc = je.run_scaled(jnp.asarray(pts), jnp.asarray(w))
        jsub = je.run_subspace(jnp.asarray(pts), jnp.asarray(dm))
    with pytest.warns(DeprecationWarning, match="run is deprecated"):
        trun = te.run(queries, masks=masks)
    with pytest.warns(DeprecationWarning, match="run_scaled"):
        tsc = te.run_scaled(pts, w)
    with pytest.warns(DeprecationWarning, match="run_subspace"):
        tsub = te.run_subspace(pts, dm)
    for got, want in ((trun, jrun), (tsc, jsc), (tsub, jsub)):
        assert_answers_equal(got, want, "sliced")
    new = te.submit_many([SkylineRequest(data=x, mask=m)
                          for x, m in zip(queries, masks)])
    assert_answers_equal(new, jrun, "sliced")
    with pytest.raises(ValueError, match="weights must be"):
        with pytest.warns(DeprecationWarning):
            te.run_scaled(pts, w[:, :3])
    with pytest.raises(ValueError, match="keys for"):
        with pytest.warns(DeprecationWarning):
            te.run(queries, keys=[1, 2])


def test_fused_pipeline_launches_once_per_bucket(monkeypatch):
    """The counterpart of the reference's compile-once check: a bucket
    of Q same-shape queries takes the sweep calls of one query (2 at
    the default config), whatever Q."""
    _, te = engines(min_n_bucket=256)
    calls = []
    orig = sops.sfs_sweep
    monkeypatch.setattr(tsfs, "sfs_sweep",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    for q in (1, 3, 4, 7):
        calls.clear()
        te.submit_many([SkylineRequest(data=_data("uniform", 200, 3, i))
                        for i in range(q)])
        assert len(calls) == 2, q


def test_engine_pack_keys_bounded_by_size_buckets():
    """Q inside one Q bucket and N inside one N bucket reuse one pack
    key, however ragged; a new N bucket adds one."""
    _, te = engines(min_n_bucket=256, min_q_bucket=4)
    before = teng.pack_trace_count()
    for q, n in [(3, 200), (4, 256), (2, 140), (1, 17), (4, 255)]:
        te.submit_many([SkylineRequest(data=_data("uniform", n, 3, i))
                        for i in range(q)])
    assert teng.pack_trace_count() - before <= 1
    te.submit_many([SkylineRequest(data=_data("uniform", 300, 3, 0))])
    assert teng.pack_trace_count() - before <= 2


def test_mesh_raises_naming_item_8():
    """Item 8 is ported: a mesh argument that is not a `WorkerMesh`
    raises ``TypeError``, a real mesh runs (here a world of one, every
    bucket sharded, the one-device answers bit for bit), and an engine
    without a mesh calibrates nothing (the reference's no-mesh
    report)."""
    from repro_torch.launch.mesh import make_engine_mesh
    with pytest.raises(TypeError, match="WorkerMesh"):
        teng.SkylineEngine(tpar.SkyConfig(), mesh=object(), device="cpu")
    sharded = teng.SkylineEngine(tpar.SkyConfig(p=4),
                                 mesh=make_engine_mesh(device="cpu"),
                                 shard_threshold_n=64)
    plain = teng.SkylineEngine(tpar.SkyConfig(p=4), device="cpu")
    reqs = [SkylineRequest(data=_data("uniform", n, 3, i))
            for i, n in enumerate((100, 300))]
    for (a, _), (b, _) in zip(sharded.submit_many(reqs),
                              plain.submit_many(reqs)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert sharded.sharded_dispatched == 2
    report = teng.calibrate_shard_threshold(engines()[1])
    assert report["applied"] is False and report["measurements"] == {}
    assert report["threshold_n"] == 4096    # the reference's default


@pytest.mark.parametrize("strategy", ["sliced", "grid"])
def test_member_masks_match_jax_one_launch_per_bucket(strategy,
                                                      monkeypatch):
    """Membership masks bit for bit the JAX engine's, ragged and masked,
    with ONE dominance call per size bucket."""
    je, te = engines(strategy)
    crits = [_data(k, n, 3, i) for i, (k, n) in enumerate(SPECS)]
    masks = [None, None, np.arange(100) % 4 != 1, None, None, None]
    want = je.member_masks([jnp.asarray(c) for c in crits],
                           masks=[None if m is None else jnp.asarray(m)
                                  for m in masks])
    calls = []
    orig = dops.dominated_mask
    monkeypatch.setattr(teng, "dominated_mask",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    got = te.member_masks(crits, masks=masks)
    assert len(calls) == 2                          # N buckets 128, 256
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _queue(rng, n, zeros=False):
    slack = rng.exponential(10.0, n).astype(np.float32)
    if zeros:
        slack[::7] = -0.0
        slack[3::11] = 1e-40
    return (slack, (-rng.integers(0, 3, n)).astype(np.float32),
            rng.integers(8, 64, n).astype(np.float32))


@pytest.mark.parametrize("zeros", [False, True])
def test_scheduler_admission_through_engine(zeros):
    """`admit_many` equals `admit` per queue, and both give the JAX
    scheduler's fronts and admitted indices."""
    je, te = engines()
    rng = np.random.default_rng(0)
    raw = [_queue(rng, 24, zeros) for _ in range(3)] + [_queue(rng, 90)]
    tq = [tsched.Request(*r) for r in raw]
    jq = [jsched.Request(*(jnp.asarray(x) for x in r)) for r in raw]
    many = tsched.admit_many(tq, 4, engine=te)
    jmany = jsched.admit_many(jq, 4, engine=je)
    assert len(many) == 4
    for reqs, jreqs, (picked, front), (jp, jf) in zip(tq, jq, many, jmany):
        one_picked, one_front = tsched.admit(reqs, 4, engine=te)
        assert torch.equal(front, one_front)
        assert torch.equal(picked, one_picked)
        np.testing.assert_array_equal(front.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(picked.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(
            tsched._criteria(reqs).numpy().view(np.int32),
            np.asarray(jsched._criteria(jreqs)).view(np.int32))
        assert int(front.sum()) >= 1


def test_request_and_options_validation():
    x = _data("uniform", 10, 3, 0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        SkylineRequest(data=x, scale=np.ones(3), subspace=np.ones(3, bool))
    with pytest.raises(ValueError, match="shape"):
        SkylineRequest(data=x, scale=np.ones(4))
    with pytest.raises(ValueError, match="unknown kernel backend"):
        SkylineRequest(data=x, impl="nope")
    with pytest.raises(ValueError, match="int seed"):
        SkylineRequest(data=x, key=np.zeros(2, np.uint32))
    with pytest.raises(ValueError, match="dtype"):
        StreamOptions(dtype=torch.float16)
    with pytest.raises(ValueError, match="windowed"):
        StreamOptions(epoch_capacity=8)
    SkylineRequest(data=x, impl="cuda")      # named right: checked later
    with pytest.raises(ValueError, match="CUDA tensors only"):
        engines()[1].submit(SkylineRequest(data=x, impl="cuda"))


def test_per_request_impl_override_matches():
    """``impl='perpair'`` on one request runs the oracle sweep for that
    group only, with the same bits."""
    _, te = engines()
    queries, masks = _requests(seed=9)
    a = te.submit_many([SkylineRequest(data=x, mask=m)
                        for x, m in zip(queries, masks)])
    b = te.submit_many([SkylineRequest(data=x, mask=m, impl="perpair")
                        for x, m in zip(queries, masks)])
    for (ba, _), (bb, _) in zip(a, b):
        for g, w in zip(ba, bb):
            assert torch.equal(g, w)


def test_random_seeds_change_ids_not_answers():
    """The random strategy draws each query's ids from its own seed:
    other seeds route rows otherwise and give the same answer."""
    _, te = engines("random")
    queries, masks = _requests(seed=2)
    a = te.submit_many([SkylineRequest(data=x, mask=m, key=i)
                        for i, (x, m) in enumerate(zip(queries, masks))])
    b = te.submit_many([SkylineRequest(data=x, mask=m, key=1000 + i)
                        for i, (x, m) in enumerate(zip(queries, masks))])
    for (ba, _), (bb, _) in zip(a, b):
        for g, w in zip(ba, bb):
            assert torch.equal(g, w)
