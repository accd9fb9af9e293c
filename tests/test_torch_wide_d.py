"""Wide attribute counts (d > 12) through the port against the JAX
package, bit for bit.

The JAX package's GPU kernels take any d (they pad the attribute rows),
and so do the port's CUDA kernels, whose wide variants take d at run
time past their narrow instantiations.  On the CPU the port runs the
kernels' plain versions; here they meet the JAX package's ``'perpair'``
sweep and ``'jnp'`` dominance on the same numpy inputs at d = 13, 16, 20
and 32, on quantised, tie-heavy data with ``-0.0`` as the reference's
d = 20 tests make it, and on quantised correlated data, where rows
dominate one another at any d.  Compared: every leaf, f32 through its
int32 bits (so ``-0.0`` against ``+0.0`` fails).  Tolerance: zero.

NoSeq is held against the reference, not against the O(N^2) oracle: the
port keeps the reference's tie behaviour there, and no draw is chosen
to avoid it.  The resolution tests hold that the card's spec takes any
d and that the CUDA entries refuse CPU data for its device, not for its
width.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dominance as jdom
from repro.core import incremental as jinc
from repro.core import parallel as jpar
from repro.core import sfs as jsfs
from repro.kernels import backend as jbackend
from repro.kernels.dominance import dominated_mask as jdominated
from repro_torch import convert
from repro_torch.core import api as tapi
from repro_torch.core import dominance as tdom
from repro_torch.core import incremental as tinc
from repro_torch.core import sfs as tsfs
from repro_torch.kernels import backend
from repro_torch.kernels.dominance import ops as dops
from repro_torch.kernels.sfs import ops as sops

WIDE = (13, 16, 20, 32)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends (each
    keeps memory mappings of its machine code; see test_torch_parallel)."""
    yield
    jax.clear_caches()
    gc.collect()


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=msg)


def _data(kind, shape, seed):
    """``ties``: the reference's d = 20 data (three levels), some -0.0;
    ``corr``: a per-row level plus quantised noise, so that rows dominate
    one another at any d, with ties and duplicates."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        x = rng.integers(0, 3, shape) / 3.0
        x[rng.random(shape) < 0.05] = -0.0
    else:
        base = rng.random(shape[:-1] + (1,))
        x = np.round((base + 0.25 * rng.random(shape)) * 16) / 16
    return x.astype(np.float32)


@pytest.mark.parametrize("d", WIDE)
@pytest.mark.parametrize("kind,capacity", [("ties", 200), ("corr", 200),
                                           ("ties", 24)],
                         ids=["ties", "corr", "overflow"])
def test_local_skyline_batch(d, kind, capacity):
    x = _data(kind, (3, 200, d), seed=d)
    mask = np.random.default_rng(d + 1).random((3, 200)) > 0.15
    mask[2] = False if kind == "corr" else mask[2]   # an all-masked one
    want = jsfs.local_skyline_batch(jnp.asarray(x), jnp.asarray(mask),
                                    capacity=capacity, block=32,
                                    impl="perpair")
    got = tsfs.local_skyline_batch(torch.from_numpy(x),
                                   torch.from_numpy(mask),
                                   capacity=capacity, block=32)
    for g, w, name in zip(got, want, ("points", "mask", "count",
                                      "overflow")):
        _eq(g, w, f"{name} at d={d} {kind} capacity={capacity}")
    assert bool(np.asarray(want.overflow).any()) == (capacity == 24)


def _run_both(x, **cfg_kw):
    jcfg = jpar.SkyConfig(impl="perpair", **cfg_kw)
    jbuf, jstats = jpar.parallel_skyline(jnp.asarray(x), None, cfg=jcfg)
    tcfg = convert.config_from_reference(
        dict(dataclasses.asdict(jcfg), impl="auto"))
    tbuf, tstats = tapi.parallel_skyline(x, cfg=tcfg, device="cpu")
    for g, w, name in zip(convert.buffer_to_numpy(tbuf), jbuf,
                          ("points", "mask", "count", "overflow")):
        _eq(g, w, f"{name} differs, {cfg_kw}")
    assert set(tstats) == set(jstats)
    for k in jstats:
        _eq(tstats[k], jstats[k], f"stat {k}, {cfg_kw}")
    return tbuf


@pytest.mark.parametrize("d,opt", [
    (13, {}), (16, {}), (20, {}), (32, {}),
    (16, dict(rep_filter="sorted")), (32, dict(rep_filter="sorted")),
    (13, dict(noseq=True)), (20, dict(noseq=True))],
    ids=["13", "16", "20", "32", "16-sorted", "32-sorted", "13-noseq",
         "20-noseq"])
def test_parallel_skyline_default_config(d, opt):
    """The default config (sliced, p = 8, flat merge), with the
    representative filter and with NoSeq."""
    x = np.concatenate([_data("corr", (500, d), seed=d),
                        _data("ties", (100, d), seed=d + 50)])
    buf = _run_both(x, **opt)
    assert not bool(buf.overflow) and int(buf.count) > 0


@pytest.mark.parametrize("d", [13, 32])
def test_insert_chunk_three_chunks(d):
    """Three inserts into a live state, each leaf of the state and each
    snapshot the reference's, the last snapshot the one-shot answer."""
    jcfg = jpar.SkyConfig(p=4, capacity=512, block=64, impl="perpair",
                          donate=False)
    tcfg = convert.config_from_reference(
        dict(dataclasses.asdict(jcfg), impl="auto"))
    js = jinc.init_state(jcfg, d)
    ts = tinc.init_state(tcfg, d, device="cpu")
    x = np.concatenate([_data("corr", (240, d), seed=d),
                        _data("ties", (60, d), seed=d + 7)])
    for i, (a, b) in enumerate([(0, 100), (100, 200), (200, 300)]):
        chunk = x[a:b]
        mask = np.ones(b - a, bool)
        js, _ = jinc.insert_chunk_fn(jcfg)(
            js, jnp.asarray(chunk), jnp.asarray(mask),
            jax.random.fold_in(jax.random.PRNGKey(42), i))
        ts, _ = tinc.insert_chunk(ts, chunk, mask, cfg=tcfg)
        for name, g, w in zip(tinc.SkylineState._fields, ts, js):
            _eq(g, w, f"state.{name} after insert {i} at d={d}")
        got = tinc.finalize(ts, cfg=tcfg)
        for g, w in zip(got, jinc.finalize(js, cfg=jcfg)):
            _eq(g, w, f"snapshot after insert {i} at d={d}")
    one, _ = tapi.parallel_skyline(x, cfg=tcfg, device="cpu")
    for g, w in zip(got, one):
        _eq(g, w.numpy(), f"the last snapshot is not the one-shot at d={d}")


@pytest.mark.parametrize("d", WIDE)
def test_dominated_mask_batch_and_lower_tri(d):
    """A batch axis with shared and per-batch references, and lower_tri,
    each batch against the reference's 'jnp'."""
    rng = np.random.default_rng(100 + d)
    cands = np.concatenate([_data("corr", (3, 150, d), seed=d),
                            _data("ties", (3, 50, d), seed=d + 1)], 1)
    refs = _data("corr", (3, 120, d), seed=d + 2)
    mask = rng.random((3, 120)) > 0.3
    tc, tr, tm = (torch.from_numpy(a) for a in (cands, refs, mask))
    cases = [(tc, tr, tm, False, refs, mask),
             (tc, tr[:1].expand(3, -1, -1), tm, False,
              np.broadcast_to(refs[:1], refs.shape), mask),
             (tc, tc, torch.from_numpy(rng.random((3, 200)) > 0.2), True,
              None, None)]
    for c, r, m, lt, rn, mn in cases:
        got = dops.dominated_mask(c, r, m, lower_tri=lt)
        rn = cands if rn is None else rn
        mn = m.numpy() if mn is None else mn
        for b in range(3):
            want = jdominated(jnp.asarray(cands[b]),
                              jnp.asarray(np.ascontiguousarray(rn[b])),
                              jnp.asarray(mn[b]), lower_tri=lt, impl="jnp")
            _eq(got[b], want, f"batch {b} lower_tri={lt} at d={d}")
        assert bool(got.any())


def test_the_cards_spec_takes_any_d():
    """'auto' on the card resolves to the CUDA kernels with no cap on d,
    as the reference's 'gpu' backend has none; the CUDA entries given
    d = 13 data on the CPU refuse it for its device."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert backend.resolve_spec("auto", cuda).max_d is None
    assert backend.resolve_spec("auto", cuda).max_d == \
        jbackend.resolve_spec("gpu").max_d
    for name in ("cuda", "torch", "perpair"):
        assert backend.impl_max_d(name) is None
        assert backend.resolve_spec(name, cuda).max_d is None
    for name in ("torch", "perpair"):
        assert backend.impl_max_d(name) == jbackend.impl_max_d(
            {"torch": "jnp"}.get(name, name))
    assert backend.impl_max_d("unknown") is jbackend.impl_max_d("unknown")
    x = torch.rand(2, 64, 13)
    m = torch.ones(2, 64, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        sops.sfs_sweep(x, m, block=32, wcap=64, sentinel=1.7e38,
                       spec="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        dops.dominated_mask(x, x, m, impl="cuda")
    assert backend.resolve_spec("auto", cpu).sweep == "torch"


def test_register_backend_as_the_reference():
    """A registered spec resolves by name; a name taken or 'auto' raise,
    as in the reference."""
    spec = backend.KernelSpec("wide-test", sweep="perpair",
                              dominance="torch")
    jspec = jbackend.KernelSpec("wide-test", sweep="perpair",
                                dominance="jnp")
    try:
        backend.register_backend(spec)
        jbackend.register_backend(jspec)
        assert backend.resolve_spec("wide-test", torch.device("cpu")) is spec
        assert "wide-test" in backend.available_backends()
        for mod, sp in ((backend, spec), (jbackend, jspec)):
            with pytest.raises(ValueError, match="already registered"):
                mod.register_backend(sp)
            mod.register_backend(sp, overwrite=True)
            with pytest.raises(ValueError, match="reserved"):
                mod.register_backend(dataclasses.replace(sp, name="auto"))
    finally:
        backend._REGISTRY.pop("wide-test", None)
        jbackend._REGISTRY.pop("wide-test", None)


@pytest.mark.parametrize("d", [3, 20])
def test_dominance_matrix_matches_jax(d):
    x = _data("corr", (60, d), seed=d)
    y = _data("ties", (45, d), seed=d + 3)
    for refs, cands in ((x, y), (x, x), (y, x)):
        got = tdom.dominance_matrix(torch.from_numpy(refs),
                                    torch.from_numpy(cands))
        want = jdom.dominance_matrix(jnp.asarray(refs), jnp.asarray(cands))
        _eq(got, want, f"dominance_matrix at d={d}")
