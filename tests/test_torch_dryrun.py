"""The port's skyline dry run (`repro_torch.launch.dryrun --skyline`) on
a gloo world of two CPU ranks at smoke size: every cell of
``SKYLINE_CELLS`` runs, each record holds the reference's keys (less the
TPU cost analysis and roofline) with the memory and collectives of each
rank, the tree-merge cell records ceil(log2 W) ppermute rounds, a second
run reads the cache, and the model cells are refused."""

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
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *flags], env=env, capture_output=True, text=True,
                          timeout=timeout)


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


def test_model_cells_are_refused():
    out = _dryrun("--device", "cpu", timeout=60)
    assert out.returncode != 0 and "14c" in out.stderr
