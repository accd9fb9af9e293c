"""The port's kernel autotuner against ``repro.kernels.tuning``.

Case for case the counterpart of ``tests/test_kernel_tuning.py`` (table
persistence, the environment's default table, the calibration's bitwise
gate, the engine's consultation rules, a tuned engine's answers), plus:
tables cross between the packages with equal JSON; the calibration's
sweep candidates under ``'torch'`` are the reference's; an entry whose
block the CUDA sweep cannot take is not applied; and the serve loop's
wave-time model falls back in the JAX loop's order.  Engines and
calibration run on the CPU.  Tolerance: zero.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import parallel as jpar
from repro.kernels import tuning as jtuning
from repro.serve import engine as jeng
from repro.serve import loop as jloop
from repro_torch import convert
from repro_torch.core.parallel import SkyConfig
from repro_torch.kernels import backend
from repro_torch.kernels.sfs import kernel as sfs_kernel
from repro_torch.kernels.tuning import (TuneEntry, TuningTable,
                                        calibrate_kernels, default_table,
                                        set_default_table, sweep_candidates,
                                        tuning_key)
from repro_torch.serve import loop as tloop
from repro_torch.serve.engine import SkylineEngine, SkylineRequest


@pytest.fixture(autouse=True)
def _clean_default_tables():
    set_default_table(None)
    jtuning.set_default_table(None)
    yield
    set_default_table(None)
    jtuning.set_default_table(None)


def _table(block=128, wtile=128, ok=True):
    return TuningTable(entries={
        tuning_key("sweep", 4, torch.float32):
            TuneEntry(block=block, wtile=wtile, time_us=1.0, impl="torch",
                      bitwise_ok=ok)})


def _engine(**cfg):
    return SkylineEngine(SkyConfig(**cfg), device="cpu")


def test_table_json_roundtrip(tmp_path):
    t = _table()
    path = t.save(str(tmp_path / "sub" / "tuning.json"))
    t2 = TuningTable.load(path)
    assert t2.to_json() == t.to_json()
    assert t2.lookup("sweep", 4, torch.float32).block == 128
    assert t2.lookup("sweep", 4, np.float32).block == 128
    assert t2.lookup("sweep", 4, "float32").block == 128
    assert t2.lookup("sweep", 7, torch.float32) is None
    assert len(t2) == 1
    assert tuning_key("sweep", 4, torch.bfloat16) == \
        jtuning.tuning_key("sweep", 4, jnp.bfloat16)


def test_env_var_loads_default_table(tmp_path, monkeypatch):
    path = _table(block=64, wtile=64).save(str(tmp_path / "t.json"))
    monkeypatch.setenv("REPRO_KERNEL_TUNING", path)
    set_default_table(None)  # re-arm the lazy load
    tab = default_table()
    assert tab is not None and tab.lookup("sweep", 4, "float32").block == 64
    # a broken path gives None, never raises
    monkeypatch.setenv("REPRO_KERNEL_TUNING", str(tmp_path / "nope.json"))
    set_default_table(None)
    assert default_table() is None
    (tmp_path / "bad.json").write_text("{not json")
    monkeypatch.setenv("REPRO_KERNEL_TUNING", str(tmp_path / "bad.json"))
    set_default_table(None)
    assert default_table() is None


def test_calibrate_kernels_quick():
    rep = calibrate_kernels(None, ds=(4,), n=512, p=2, capacity=256,
                            blocks=(64, 128), repeat=1, apply=True,
                            device="cpu")
    table = rep["table"]
    assert len(table) == 2 and rep["divergent"] == []
    entry = table.lookup("sweep", 4, torch.float32)
    assert entry is not None and entry.bitwise_ok
    # the winner is the argmin of the measured (verified) candidates
    times = rep["keys"][tuning_key("sweep", 4, torch.float32)]["times_us"]
    assert times[f"b{entry.block}/t{entry.wtile}"] == min(times.values())
    # under 'torch' the candidates are the reference's grid
    assert sorted(times) == sorted(
        f"b{b}/t{t}" for b, t in jtuning._sweep_candidates((64, 128), 256))
    dom = table.lookup("dominance", 4, torch.float32)
    assert (dom.block, dom.wtile, dom.impl, dom.bitwise_ok) == \
        (0, 0, "torch", True)
    assert table.topology["platform"] == "cpu"
    # apply=True with engine=None installs the process default
    assert default_table() is table


def test_calibrate_applies_to_an_engine(tmp_path):
    eng = _engine()
    path = str(tmp_path / "t.json")
    rep = calibrate_kernels(eng, n=256, p=2, capacity=128, blocks=(64,),
                            repeat=1, path=path)
    assert eng.kernel_tuning is rep["table"] and default_table() is None
    assert TuningTable.load(path).to_json() == rep["table"].to_json()
    with pytest.raises(ValueError, match="float32"):
        calibrate_kernels(eng, dtypes=(torch.bfloat16,), n=256, p=2,
                          blocks=(64,), repeat=1)


@pytest.mark.parametrize("blocks,capacity", [
    ((64, 128), 256), ((128, 256, 512), 4096), ((64,), 100), ((96,), 500),
    ((256,), 64)])
def test_sweep_candidates_match_the_reference(blocks, capacity):
    assert sweep_candidates("torch", blocks, capacity, 4) == \
        jtuning._sweep_candidates(blocks, capacity)
    # the CUDA sweep takes no tile: one candidate per block it takes
    assert sweep_candidates("cuda", blocks + (1024,), capacity, 4) == \
        [(b, 0) for b in blocks if b <= sfs_kernel.MAX_BLOCK]
    # at d = 128 its footprint law refuses blocks above 349
    assert sweep_candidates("cuda", blocks, capacity, 128) == \
        [(b, 0) for b in blocks if b <= 349]


def test_tables_cross_between_the_packages(tmp_path):
    ref = jtuning.TuningTable(
        entries={
            jtuning.tuning_key("sweep", 4, jnp.float32):
                jtuning.TuneEntry(block=256, wtile=0, time_us=12.5,
                                  impl="pallas"),
            jtuning.tuning_key("dominance", 4, jnp.bfloat16):
                jtuning.TuneEntry(block=128, wtile=0, time_us=3.0,
                                  impl="jnp", bitwise_ok=False)},
        topology={"platform": "tpu", "devices": 8})
    path = ref.save(str(tmp_path / "ref.json"))
    ported = TuningTable.load(path)
    assert ported.to_json() == ref.to_json()
    assert ported.lookup("sweep", 4, torch.float32).block == 256
    assert not ported.lookup("dominance", 4, torch.bfloat16).bitwise_ok

    rep = calibrate_kernels(None, n=256, p=2, capacity=128, blocks=(64,),
                            repeat=1, apply=False, device="cpu")
    back = jtuning.TuningTable.load(rep["table"].save(
        str(tmp_path / "port.json")))
    assert back.to_json() == rep["table"].to_json()
    assert sorted(back.entries) == [
        jtuning.tuning_key("dominance", 4, jnp.float32),
        jtuning.tuning_key("sweep", 4, jnp.float32)]
    with open(path) as f, open(ported.save(str(tmp_path / "again.json"))) \
            as g:
        assert f.read() == g.read()


def _cfg_case(eng_kw, table, impl, d):
    """The tuned config of the port's and the reference's engine."""
    jcfg = jpar.SkyConfig(**eng_kw)
    j = jeng.SkylineEngine(jcfg)
    j.kernel_tuning = None if table is None else \
        jtuning.TuningTable.from_json(table.to_json())
    t = SkylineEngine(convert.config_from_reference(
        dataclasses.asdict(jcfg)), device="cpu")
    t.kernel_tuning = table
    return (dataclasses.asdict(t._cfg_for(impl, d, "float32")),
            dataclasses.asdict(j._cfg_for(impl, d, "float32")))


def test_engine_consults_table_only_for_auto():
    eng = _engine()
    eng.kernel_tuning = _table()
    tuned = eng._cfg_for(None, 4, "float32")
    assert (tuned.block, tuned.wtile) == (128, 128)
    # value-equal configs share the config key
    assert tuned == dataclasses.replace(eng.cfg, block=128, wtile=128)
    # no entry for this (d, dtype) -> untouched config
    assert eng._cfg_for(None, 7, "float32") == eng.cfg
    # an explicit per-request impl bypasses tuning entirely
    assert eng._cfg_for("perpair", 4, "float32").wtile == 0
    # a non-'auto' engine impl is never overridden
    eng_t = _engine(impl="torch")
    eng_t.kernel_tuning = _table()
    assert eng_t._cfg_for(None, 4, "float32") == eng_t.cfg
    # an explicitly pinned wtile wins over the table
    eng_pin = _engine(wtile=64)
    eng_pin.kernel_tuning = _table()
    assert eng_pin._cfg_for(None, 4, "float32").wtile == 64
    # a divergent entry is never applied
    eng_bad = _engine()
    eng_bad.kernel_tuning = _table(ok=False)
    assert eng_bad._cfg_for(None, 4, "float32") == eng_bad.cfg
    # the process default serves an engine without its own table
    set_default_table(_table(block=64, wtile=0))
    assert _engine()._cfg_for(None, 4, "float32").block == 64
    assert eng._cfg_for(None, 4, "float32").block == 128


@pytest.mark.parametrize("eng_kw,impl,d", [
    ({}, None, 4), ({}, None, 7), ({}, None, None), ({}, "perpair", 4),
    ({"wtile": 64}, None, 4), ({"capacity": 512, "block": 64}, None, 4)])
@pytest.mark.parametrize("ok", [True, False])
def test_engine_rules_match_the_reference(eng_kw, impl, d, ok):
    got, want = _cfg_case(eng_kw, _table(ok=ok), impl, d)
    assert got == want


def test_engine_rules_match_the_reference_on_default_table():
    table = _table(block=64, wtile=0)
    set_default_table(table)
    jtuning.set_default_table(
        jtuning.TuningTable.from_json(table.to_json()))
    got, want = _cfg_case({}, None, None, 4)
    assert got == want and got["block"] == 64


def test_cuda_sweep_skips_blocks_it_cannot_take():
    """A table written elsewhere may name a block above the CUDA kernel's
    MAX_BLOCK: an engine whose sweep resolves to 'cuda' does not apply
    it.  The spec is resolved for the card; nothing is launched."""
    eng = _engine()
    eng.kernel_spec = backend.resolve_spec("auto", torch.device("cuda"))
    assert eng.kernel_spec.sweep == "cuda"
    eng.kernel_tuning = _table(block=2 * sfs_kernel.MAX_BLOCK, wtile=0)
    assert eng._cfg_for(None, 4, "float32") == eng.cfg
    eng.kernel_tuning = _table(block=sfs_kernel.MAX_BLOCK, wtile=0)
    assert eng._cfg_for(None, 4, "float32").block == sfs_kernel.MAX_BLOCK
    # the plain version takes any block
    cpu = _engine()
    cpu.kernel_tuning = _table(block=2 * sfs_kernel.MAX_BLOCK, wtile=0)
    assert cpu._cfg_for(None, 4, "float32").block == \
        2 * sfs_kernel.MAX_BLOCK


def test_tuned_engine_answers_bitwise_identical():
    rng = np.random.default_rng(0)
    pts = (rng.integers(0, 9, (700, 4)) / 9).astype(np.float32)
    reqs = [SkylineRequest(data=pts), SkylineRequest(data=pts[:300]),
            SkylineRequest(data=pts, scale=np.float32([1, 2, 1, 1]))]
    for table in (_table(), _table(block=64, wtile=0)):
        eng = _engine()
        eng.kernel_tuning = table
        plain = _engine()
        for (bt, _), (bp, _) in zip(eng.submit_many(reqs),
                                    plain.submit_many(reqs)):
            np.testing.assert_array_equal(bt.points.numpy().view(np.int32),
                                          bp.points.numpy().view(np.int32))
            np.testing.assert_array_equal(bt.mask.numpy(), bp.mask.numpy())
            assert int(bt.count) == int(bp.count)


def test_wave_time_falls_back_in_the_reference_order():
    """EWMA entry, then the cross-bucket scalar when non-zero, then the
    tuning floor of (d, dtype), then 0, on the same table and hints as
    the JAX loop."""
    table = TuningTable(entries={
        "sweep/d=4/dtype=float32": TuneEntry(256, 0, 250.0, "torch"),
        "sweep/d=3/dtype=float32": TuneEntry(128, 0, 40.0, "torch"),
        "dominance/d=4/dtype=float32": TuneEntry(0, 0, 9.0, "torch"),
        "sweep/d=x/dtype=float32": TuneEntry(64, 0, 1.0, "torch"),
        "sweep/bad": TuneEntry(64, 0, 1.0, "torch")})
    hints = {(4, "float32", 1024): 0.002}
    teng = _engine()
    jengine = jeng.SkylineEngine(jpar.SkyConfig())
    teng.kernel_tuning = table
    jengine.kernel_tuning = jtuning.TuningTable.from_json(table.to_json())
    teng.wave_time_hints = dict(hints)
    jengine.wave_time_hints = dict(hints)
    tl = tloop.ServeLoop(teng)
    jl = jloop.ServeLoop(jengine)
    assert tl._tuning_floor == jl._tuning_floor == {
        (4, "float32"): 250.0 * 1e-6, (3, "float32"): 40.0 * 1e-6}
    keys = [(4, "float32", 1024), (4, "float32", 64), (3, "float32", 64),
            (5, "float32", 64), (4, "bfloat16", 64)]
    for ewma in (0.0, 0.01):
        tl._ewma = jl._ewma = ewma
        assert [tl._wave_time(k) for k in keys] == \
            [jl._wave_time(k) for k in keys]
    tl._ewma = 0.0
    assert [tl._wave_time(k) for k in keys] == \
        [0.002, 250.0 * 1e-6, 40.0 * 1e-6, 0.0, 0.0]


def test_cuda_sweep_skips_blocks_past_its_law_at_the_streams_d():
    """Past d = 12 the CUDA sweep's footprint law bounds the block: at
    d = 128 the largest is 349, so a tuned block of 512 is not applied
    there, while at d = 64 it is.  Nothing is launched."""
    eng = _engine()
    eng.kernel_spec = backend.resolve_spec("auto", torch.device("cuda"))
    entry = TuneEntry(block=512, wtile=0, time_us=1.0, impl="cuda")
    eng.kernel_tuning = TuningTable(entries={
        tuning_key("sweep", d, torch.float32): entry for d in (64, 128)})
    assert sfs_kernel.largest_block(128) == 349
    assert eng._cfg_for(None, 128, "float32") == eng.cfg
    assert eng._cfg_for(None, 64, "float32").block == 512


def test_calibration_takes_a_wide_d():
    """calibrate_kernels skips no d: at d = 13 both families get an entry,
    each checked bit for bit against its oracle."""
    rep = calibrate_kernels(None, ds=(13,), n=256, p=2, capacity=128,
                            blocks=(64,), repeat=1, apply=False,
                            device="cpu")
    assert sorted(rep["table"].entries) == [
        tuning_key("dominance", 13, torch.float32),
        tuning_key("sweep", 13, torch.float32)]
    assert rep["divergent"] == []
