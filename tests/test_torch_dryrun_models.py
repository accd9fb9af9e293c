"""The model cells of the port's dry run (`repro_torch.launch.dryrun`
without ``--skyline``) on a fake world of the production mesh's size,
beside ``tests/test_torch_dryrun.py``'s train cell: a decode cell's
record, the reference's skip reasons, the cache, the usage errors, and
the refusal without the fake backend.

What is held how:

| What | How it is held |
| --- | --- |
| A decode cell's record (yi-6b's smoke decode_32k on 256 ranks) | its keys; rank 0's argument bytes exactly the local shards' bytes of the parameters, caches and inputs; collectives by mesh axis |
| A skipped cell (an encoder has no decode step) | the reference's reason, exactly |
| A second run | the cached record, not run again |
| No fake backend | a non-zero exit that says why; no smaller world |
| The multi-pod cell (yi-6b's smoke train_4k on 512 ranks, the reference's ``test_dryrun_smoke_cell_multipod``) | ``[ok]``, 512 chips, the gradient's reduction over the ``pod`` axis among the collectives |
| A sequence-parallel prefill cell (qwen3-14b's smoke prefill_32k on 256 ranks) | ``[ok]``, the rules' ``seq`` and ``kv_seq`` over ``model``, collectives over ``model`` |
"""

import _torch_threads  # noqa: F401  (one torch thread)
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import arch_rules, get_config, skip_reason
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dryrun(*flags, timeout=240):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    return subprocess.run(
        _torch_threads.python_m("repro_torch.launch.dryrun", *flags),
        env=env, capture_output=True, text=True, timeout=timeout)


def _local_bytes(cfg, shape):
    """Rank 0's bytes of a decode cell's arguments on the (16, 16) mesh,
    by the specs' own placements (a world of the fake backend in a
    subprocess: this process may have a world of its own)."""
    code = (
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from repro_torch.configs import arch_rules, get_config\n"
        "from repro_torch.launch.mesh import fake_world, "
        "make_production_mesh\n"
        "from repro_torch.launch.specs import cache_specs, input_specs, "
        "state_specs\n"
        "from repro_torch.models.transformer import tree_map\n"
        f"cfg = get_config({cfg!r}, smoke=True)\n"
        f"rules = arch_rules(cfg, {shape!r})\n"
        "total = []\n"
        "with fake_world(256):\n"
        "    mesh = make_production_mesh(device='cpu')\n"
        "    for tree in (state_specs(cfg, mesh, rules)['params'],\n"
        f"                 cache_specs(cfg, {shape!r}, mesh, rules),\n"
        f"                 input_specs(cfg, {shape!r}, mesh, rules)):\n"
        "        tree_map(lambda t: total.append(t.to_local().numel()\n"
        "                 * t.element_size()), tree)\n"
        "print(sum(total))\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    return int(out.stdout.split()[-1])


def test_decode_cell_and_skips_and_cache(tmp_path):
    res = str(tmp_path / "res")
    out = _dryrun("--arch", "yi-6b", "--shape", "decode_32k", "--smoke",
                  "--device", "cpu", "--results", res)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.splitlines()[-1] == "done: ok=1 skip=0 err=0"
    rec = json.load(open(os.path.join(
        res, "yi-6b__decode_32k__pod__smoke.json")))
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert set(rec) >= {"memory_analysis", "cost_analysis", "collectives",
                        "roofline", "card", "compile_seconds"}
    assert rec["memory_analysis"]["argument_bytes"] == _local_bytes(
        "yi-6b", "decode_32k")
    assert {k.split("@")[1] for k in rec["collectives"]["per_chip"]} <= \
        {"data", "model"}
    # the encoder has no decode step: the reference's skip record
    out = _dryrun("--arch", "hubert-xlarge", "--shape", "decode_32k",
                  "--smoke", "--device", "cpu", "--results", res,
                  timeout=60)
    assert out.returncode == 0, out.stderr[-4000:]
    skip = json.load(open(os.path.join(
        res, "hubert-xlarge__decode_32k__pod__smoke.json")))
    assert skip == {"cell": "hubert-xlarge__decode_32k__pod__smoke",
                    "status": "skipped", "reason": skip_reason(
                        get_config("hubert-xlarge"), "decode_32k")}
    # a second run reads both records from the cache
    again = _dryrun("--arch", "yi-6b", "--shape", "decode_32k", "--smoke",
                    "--device", "cpu", "--results", res, timeout=60)
    assert again.returncode == 0, again.stderr
    assert again.stdout.splitlines() == [
        "[cached] yi-6b__decode_32k__pod__smoke: ok",
        "done: ok=1 skip=0 err=0"]


def test_usage_errors_and_no_fake_backend(monkeypatch, capsys):
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "no-such-arch", "--device", "cpu"])
    with pytest.raises(SystemExit):
        dryrun.main(["--shape", "no-such-shape", "--device", "cpu"])
    monkeypatch.setattr(tmesh, "has_fake_backend", lambda: False)
    assert dryrun.main(["--arch", "yi-6b", "--shape", "train_4k",
                        "--smoke", "--device", "cpu"]) == 2
    assert "no fake process-group backend" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no fake process-group"):
        with tmesh.fake_world(256):
            pass


def test_multipod_smoke_cell(tmp_path):
    """The port's twin of the reference's ``test_dryrun_smoke_cell_multipod``:
    the 3-D (pod, data, model) mesh, its batch over two mesh dims and its
    residual stream over the sequence."""
    res = str(tmp_path / "res")
    out = _dryrun("--arch", "yi-6b", "--shape", "train_4k", "--smoke",
                  "--multi-pod", "--force", "--device", "cpu", "--results",
                  res, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.splitlines()[0].startswith(
        "[ok]     yi-6b__train_4k__multipod__smoke:")
    rec = json.load(open(os.path.join(
        res, "yi-6b__train_4k__multipod__smoke.json")))
    assert rec["status"] == "ok" and rec["chips"] == 512
    axes = {k.split("@")[1] for k in rec["collectives"]["per_chip"]}
    assert "pod" in axes and axes <= {"pod", "data", "model"}


def test_seq_parallel_prefill_cell(tmp_path):
    """A prefill cell whose residual stream and KV caches shard the
    sequence over the model axis (qwen3-14b's smoke heads do not divide
    the 16-wide axis)."""
    rules = arch_rules(get_config("qwen3-14b", smoke=True), "prefill_32k")
    assert rules["seq"] == rules["kv_seq"] == "model" \
        and rules["heads"] is None
    res = str(tmp_path / "res")
    out = _dryrun("--arch", "qwen3-14b", "--shape", "prefill_32k", "--smoke",
                  "--force", "--device", "cpu", "--results", res, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.splitlines()[-1] == "done: ok=1 skip=0 err=0"
    rec = json.load(open(os.path.join(
        res, "qwen3-14b__prefill_32k__pod__smoke.json")))
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert any(k.endswith("@model") for k in rec["collectives"]["per_chip"])
