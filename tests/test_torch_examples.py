"""The port's example drivers (`repro_torch.examples`) on the CPU, each
through its ``main`` at a cut size, with its own assertions.

* ``quickstart``: every ``parallel_skyline`` answer (and the sequential
  SFS) bit for bit the JAX package's on the same arrays, stats included;
  the random strategy takes the reference's partition ids (torch cannot
  reproduce threefry; ``test_torch_parallel.feed_reference_random_ids``).
* ``streaming_pareto`` and ``serving_pareto`` at their own sizes: the
  lines they print (the reference asserts nothing there).
* ``distributed_skyline`` on a world of 2 CPU ranks (a group timeout of
  40 s, a run deadline of 100 s): every rank's answer has the sequential
  skyline's size (the example asserts it) and the ranks agree.
* ``train_skyline_curation`` at a tiny config (2 layers, d_model 64),
  the example's 300 steps of 16 tokens: its progress lines, and its
  closing ``last < first`` holds (the reference's, kept as it is).
"""

import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses
import gc
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import parallel as jpar
from repro_torch.core.datagen import generate
from repro_torch.examples import (distributed_skyline, quickstart,
                                  serving_pareto, streaming_pareto,
                                  train_skyline_curation)
from repro_torch.models.config import ModelConfig
from test_torch_parallel import feed_reference_random_ids


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    yield
    jax.clear_caches()
    gc.collect()


def _bits(x):
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same(got_buf, got_stats, want_buf, want_stats, what):
    for g, w, name in zip(got_buf, want_buf, got_buf._fields):
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{what} {name}")
    if want_stats is not None:
        assert set(got_stats) == set(want_stats), what
        for k in want_stats:
            np.testing.assert_array_equal(_bits(got_stats[k]),
                                          _bits(want_stats[k]),
                                          err_msg=f"{what} {k}")


def test_quickstart_matches_the_jax_package(monkeypatch, capsys):
    feed_reference_random_ids(monkeypatch, [jax.random.PRNGKey(0)])
    out = quickstart.main(["--device", "cpu", "--n", "3000"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "dataset: 3000 tuples, 4 dims, anticorrelated"
    assert lines[-1] == ("done — all strategies agree with the sequential "
                         "skyline")
    assert len(lines) == 8
    pts = jnp.asarray(out["points"].numpy())
    want = japi.skyline(pts, capacity=8192, impl="perpair")
    assert_same(out["sequential"], None, want, None, "sequential")
    cfgs = {s: quickstart.strategy_config(s) for s in quickstart.STRATEGIES}
    cfgs["noseq"] = quickstart.NOSEQ
    for name, cfg in cfgs.items():
        jcfg = jpar.SkyConfig(**dict(dataclasses.asdict(cfg),
                                     impl="perpair"))
        wbuf, wstats = jpar.parallel_skyline(pts, cfg=jcfg)
        assert_same(*out[name], wbuf, wstats, name)
        assert int(out[name][0].count) == int(want.count)


def test_streaming_pareto_runs_to_its_end(capsys):
    engine = streaming_pareto.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines[:5]] == [
        f"wave {w}" for w in range(5)]
    assert "arrivals [" in lines[3] and ", 0] ->" in lines[3]  # idle tenant
    assert sum(ln.startswith("window wave") for ln in lines) == 6
    assert sum("oldest wave aged out" in ln for ln in lines) == 3
    assert any(ln.startswith("slab arenas: [((4, 'float32', ") for ln in lines)
    assert sum(ln.startswith("admission wave") for ln in lines) == 4
    admitted = [ln for ln in lines if ln.startswith("queue ")]
    assert [ln.split(":")[0] for ln in admitted] == ["queue 0", "queue 1"]
    assert all("admit 4 most-urgent" in ln for ln in admitted)
    assert engine.device.type == "cpu"


def test_serving_pareto_runs_to_its_end(capsys):
    toks = serving_pareto.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert re.match(r"engine: 8 subspace skyline queries in 1 dispatch\(es\)",
                    lines[0])
    assert re.match(r"serve loop: 6 queries ok over \d+ wave\(s\)", lines[1])
    assert lines[2].startswith("Pareto front: ")
    assert sum(ln.startswith("  req ") for ln in lines) == 4
    assert lines[-1].startswith("generated 4x16 tokens in ")
    assert lines[-1].endswith("(smoke-size MoE model, CPU)")
    assert toks.shape == (4, 16) and toks.dtype == torch.int32


def test_distributed_skyline_on_two_ranks(monkeypatch, capsys):
    monkeypatch.setattr(distributed_skyline, "DEADLINE_S", 100.0)
    monkeypatch.setattr(distributed_skyline, "GROUP_TIMEOUT_S", 40.0)
    reports = distributed_skyline.main(
        ["--device", "cpu", "--world", "2", "--n", "6000"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "mesh: 2 workers"
    assert lines[-1] == "distributed == sequential: OK"
    assert [ln.split(":")[0].strip() for ln in lines[1:3]] == [
        "seq-merge", "NoSeq"]
    assert len(reports) == 2
    for rep in reports:
        assert rep["workers"] == 2 and rep["backend"] == "gloo"
        assert [r["count"] for r in rep["runs"]] == [
            r["count"] for r in reports[0]["runs"]]
    pts = jnp.asarray(generate("anticorrelated",
                               torch.Generator().manual_seed(0), 6000,
                               4).numpy())
    want = japi.skyline(pts, capacity=8192, impl="perpair")
    assert reports[0]["runs"][0]["count"] == int(want.count)


TINY = ModelConfig(name="lm-tiny", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                   microbatches=1)


def test_curation_main_runs_the_example(monkeypatch, capsys):
    monkeypatch.setattr(train_skyline_curation, "model_config",
                        lambda big: TINY)
    out = train_skyline_curation.main(["--device", "cpu", "--seq", "16"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "model: lm-tiny (0.1M params), curation=on"
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert [int(ln.split()[1]) for ln in steps] == list(range(25, 301, 25))
    assert lines[-1] == (f"loss {out.losses[0]:.4f} -> {out.losses[-1]:.4f} "
                         f"over 300 steps")
    assert len(out.losses) == len(out.indices) == 300
    assert all(np.isfinite(out.losses))
    assert int(out.state["step"]) == 300
