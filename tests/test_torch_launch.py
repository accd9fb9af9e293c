"""The port's launch entry points: the environment (`repro_torch.launch.env`)
and the serve entry point (`repro_torch.launch.serve`).

The environment keeps what the user pinned, passes the tuning table on,
and refuses ``--devices``.  The serve entry point runs in this process on the
CPU with yi-6b's smoke config; its admission lines ("[serve] queue i:
admitted ...", the front sizes of each wave) must equal those that the
reference's ``admit_many``, ``StreamingAdmitter`` and
``WindowedAdmitter`` give on the same ``default_rng(0)`` draws, its
prompts must be the next draws of that stream, as the reference's, and
it must greedily decode them ("[serve] generated (4, 16)").  The
reference's ``main`` is not run (its language model would draw its own
parameters); the decode itself is held against the reference's
``generate`` in ``tests/test_torch_serve_lm.py``.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import gc
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import parallel as jpar
from repro.serve import scheduler as jsched
from repro_torch.kernels import tuning
from repro_torch.launch import env as tenv
from repro_torch.launch import serve as tserve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends (memory
    mappings; see ``tests/test_torch_scheduler.py``)."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(autouse=True)
def _clean_default_table():
    tuning.set_default_table(None)
    yield
    tuning.set_default_table(None)


def test_build_env_and_pinned_variables(monkeypatch):
    env = tenv.build_env(tuning="/x/t.json")
    assert env["REPRO_KERNEL_TUNING"] == "/x/t.json"
    assert env["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == "60000000000"
    assert "TF_CPP_MIN_LOG_LEVEL" not in env and "XLA_FLAGS" not in env
    assert ("LD_PRELOAD" in env) == any(os.path.exists(p) for p in
                                        tenv.TCMALLOC_PATHS)
    monkeypatch.setenv("REPRO_KERNEL_TUNING", "/pinned.json")
    monkeypatch.delenv("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD",
                       raising=False)
    applied = tenv.apply_env(tuning="/other.json")
    assert os.environ["REPRO_KERNEL_TUNING"] == "/pinned.json"
    assert "REPRO_KERNEL_TUNING" not in applied
    assert applied["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == "60000000000"
    tenv.apply_env(tuning="/other.json", overwrite=True)
    assert os.environ["REPRO_KERNEL_TUNING"] == "/other.json"
    with pytest.raises(ValueError, match="--world"):
        tenv.build_env(devices=4)


def test_env_main_execs_under_the_environment(tmp_path):
    run = dict(env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
               capture_output=True, text=True, timeout=60)
    out = subprocess.run(
        _torch_threads.python_m(
            "repro_torch.launch.env", "--tuning", str(tmp_path / "t.json"),
            sys.executable, "-c",
            "import os; print(os.environ['REPRO_KERNEL_TUNING'])"), **run)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(tmp_path / "t.json")
    bad = subprocess.run(_torch_threads.python_m(
        "repro_torch.launch.env", "--devices", "8", "true"), **run)
    assert bad.returncode != 0 and "--world" in bad.stderr


def _make_queue(rng, n):
    return jsched.Request(
        slack=jnp.asarray(rng.exponential(10.0, n), jnp.float32),
        neg_priority=jnp.asarray(-rng.integers(0, 3, n), jnp.float32),
        cost=jnp.asarray(rng.integers(8, 64, n), jnp.float32))


def _reference_lines(queues=2, requests=16, batch=4, chunks=0, window=0,
                     prompts=None):
    """The admission lines of ``repro.launch.serve`` from the reference's
    own functions on the same draws; with ``prompts=(vocab, length)``,
    also the prompts it draws next."""
    rng = np.random.default_rng(0)
    engine = jsched.make_default_engine(jpar.SkyConfig())
    lines = []
    if chunks > 0:
        per_wave = max(requests // chunks, 1)
        if window > 0:
            adm = jsched.WindowedAdmitter(queues=queues, engine=engine,
                                          window_epochs=window)
        else:
            adm = jsched.StreamingAdmitter(queues=queues, engine=engine,
                                           backfill=True)
        for wave in range(chunks):
            adm.offer([_make_queue(rng, per_wave) for _ in range(queues)])
            sizes = [f.shape[0] for f in adm.fronts()]
            if window > 0:
                aged = adm.tick() if wave < chunks - 1 else False
                lines.append(f"[serve] wave {wave}: +{per_wave} req/queue "
                             f"-> live-window front sizes {sizes}"
                             f"{' (oldest epoch aged out)' if aged else ''}")
            else:
                lines.append(f"[serve] wave {wave}: +{per_wave} req/queue "
                             f"-> front sizes {sizes}")
        for qi, b in enumerate(adm.admit(batch)):
            lines.append(
                f"[serve] queue {qi}: admitted {b.shape[0]} of "
                f"{chunks * per_wave} streamed requests (front-ranked"
                f"{', second-layer backfilled' if window <= 0 else ''})")
    else:
        qs = [_make_queue(rng, requests) for _ in range(queues)]
        for qi, (picked, front) in enumerate(
                jsched.admit_many(qs, batch, engine=engine)):
            lines.append(f"[serve] queue {qi}: admitted "
                         f"{list(np.asarray(picked))} (Pareto front size "
                         f"{int(np.asarray(front).sum())})")
    if prompts is not None:
        vocab, length = prompts
        return lines, np.asarray(jnp.asarray(
            rng.integers(0, vocab, (batch, length)), jnp.int32))
    return lines


def _serve_lines(capsys, *flags):
    tserve.main(["--device", "cpu", "--arch", "yi-6b", "--smoke",
                 "--queues", "2", "--requests", "16", "--batch", "4", *flags])
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("flags,ref", [
    ((), {}),
    (("--stream-chunks", "4"), {"chunks": 4}),
    (("--stream-chunks", "4", "--window-epochs", "2"),
     {"chunks": 4, "window": 2})], ids=["static", "stream", "window"])
def test_serve_admission_lines_match_the_reference(capsys, flags, ref,
                                                  monkeypatch):
    prompts = []
    generate = tserve.generate

    def spy(params, cfg, tokens, gen, cache_len):
        prompts.append(tokens.clone())
        return generate(params, cfg, tokens, gen, cache_len)

    monkeypatch.setattr(tserve, "generate", spy)
    out = _serve_lines(capsys, *flags)
    got = [ln for ln in out if ln.startswith(("[serve] queue",
                                              "[serve] wave"))]
    lines, want_prompts = _reference_lines(**ref, prompts=(256, 32))
    assert got == lines
    assert out[0].startswith("[serve] skyline engine mesh: none")
    assert "tuned geometries" not in out[0]
    assert out[-1].startswith("[serve] generated (4, 16) in ")
    assert out[-1].endswith(" tok/s)")
    assert len(prompts) == 1 and prompts[0].dtype == torch.int32
    np.testing.assert_array_equal(prompts[0].numpy(), want_prompts)


def test_serve_tuning_and_serve_loop(capsys, tmp_path, monkeypatch):
    table = tuning.TuningTable(entries={
        tuning.tuning_key("sweep", 4, "float32"):
            tuning.TuneEntry(64, 0, 10.0, "torch")})
    path = table.save(str(tmp_path / "t.json"))
    out = _serve_lines(capsys, "--tuning", path, "--serve-loop", "6",
                        "--slo-ms", "5000")
    assert out[0].endswith("tuned geometries: 1")
    loop = [ln for ln in out if ln.startswith("[serve] serve-loop")]
    assert len(loop) == 1 and loop[0].startswith(
        "[serve] serve-loop: 6 ok / 0 shed")
    # unset, the serve entry point reports the process default from the environment
    monkeypatch.setenv("REPRO_KERNEL_TUNING", path)
    tuning.set_default_table(None)
    assert _serve_lines(capsys)[0].endswith("tuned geometries: 1")
