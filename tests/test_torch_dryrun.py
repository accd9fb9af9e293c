"""The port's skyline dry run (`repro_torch.launch.dryrun --skyline`) on
a gloo world of two CPU ranks at smoke size: every cell of
``SKYLINE_CELLS`` runs, each record holds the reference's keys (less the
TPU cost analysis and roofline) with the memory and collectives of each
rank, the tree-merge cell records ceil(log2 W) ppermute rounds, and a
second run reads the cache.  Without ``--skyline``, a model cell's
record (yi-6b's train_4k smoke cell on the fake 256-rank world) holds
rank 0's bytes, FLOPs and collectives and the H100's roofline terms."""

import _torch_threads  # noqa: F401  (one torch thread)
import json
import math
import os
import subprocess
import sys

from repro_torch.launch.cells import SKYLINE_CELLS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"cell", "status", "chips", "config", "compile_seconds", "memory",
        "collectives"}


def _dryrun(*flags, timeout=240):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    return subprocess.run(
        _torch_threads.python_m("repro_torch.launch.dryrun", *flags),
        env=env, capture_output=True, text=True, timeout=timeout)


def test_skyline_dry_run_on_two_ranks(tmp_path):
    world = 2
    res = str(tmp_path / "res")
    out = _dryrun("--skyline", "--smoke", "--force", "--device", "cpu",
                  "--world", str(world), "--results", res)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert lines[-1] == f"done: ok={len(SKYLINE_CELLS)} err=0"
    assert sum(ln.startswith("[ok]") for ln in lines) == len(SKYLINE_CELLS)
    for name, spec in SKYLINE_CELLS.items():
        with open(os.path.join(res, f"skyline__{name}__smoke.json")) as f:
            rec = json.load(f)
        assert KEYS <= set(rec) and rec["status"] == "ok"
        assert "roofline" not in rec and "cost_analysis" not in rec
        assert rec["chips"] == world and rec["config"]["n"] == spec["n"] // 64
        assert set(rec["memory"]) == set(rec["collectives"]) == {"0", "1"}
        for mem in rec["memory"].values():
            assert mem["argument_bytes"] > 0 and mem["measured"] is False
        wire = rec["collectives"]["0"]
        if spec["kind"] == "sweep":
            assert rec["mesh"] is None and wire == {}
        else:
            assert rec["mesh"]["workers"] == world and wire
            for c in wire.values():
                assert c["bytes"] >= c["elements"] > 0 and c["count"] > 0
        if spec.get("merge") == "tree":
            rounds = math.ceil(math.log2(world))
            assert rec["tree_rounds"] == {"expected": rounds,
                                          "ppermute": rounds}
            assert wire["ppermute@workers"]["count"] == rounds

    again = _dryrun("--skyline", "--smoke", "--device", "cpu", "--world",
                    str(world), "--results", res, "--cell", "sweep_p64")
    assert again.returncode == 0, again.stderr
    assert again.stdout.splitlines() == [
        "[cached] skyline__sweep_p64__smoke: ok", "done: ok=1 err=0"]


def test_model_cell_writes_an_ok_record(tmp_path):
    res = str(tmp_path / "res")
    out = _dryrun("--arch", "yi-6b", "--shape", "train_4k", "--smoke",
                  "--device", "cpu", "--results", res)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.splitlines()[-1] == "done: ok=1 skip=0 err=0"
    with open(os.path.join(res, "yi-6b__train_4k__pod__smoke.json")) as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["chips"] == 256
    mem, cost = rec["memory_analysis"], rec["cost_analysis"]
    assert mem["argument_bytes"] > 0 and cost["flops_per_chip"] > 0
    assert mem["peak_bytes_per_chip"] >= mem["argument_bytes"]
    coll = rec["collectives"]["per_chip"]
    assert coll and all(v["count"] > 0 and v["bytes"] > 0
                        for v in coll.values())
    assert {k.split("@")[1] for k in coll} <= {"data", "model"}
    assert rec["card"]["name"].startswith("NVIDIA H100")
    assert rec["card"]["power_limit_w"] == 700.0
    r = rec["roofline"]
    assert r["compute_s"] == cost["flops_per_chip"] / 989e12
    assert rec["card"]["peak_flops_bf16_dense"] == 989e12
    assert rec["card"]["hbm_bytes_per_s"] == 3.35e12
    assert rec["card"]["nvlink_bytes_per_s_each_way"] == 450e9
    # the reference's TPU constants appear nowhere
    assert not {197e12, 819e9, 50e9} & set(_numbers(rec))


def _numbers(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _numbers(v)
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield float(tree)
