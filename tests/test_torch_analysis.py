"""The port's static verifier (`repro_torch.analysis`), case for case the
counterpart of ``tests/test_analysis.py``: each skylint rule fires on its
torch-flavoured fixture (and ONLY there), suppressions and the baseline
are honoured, the real ``src/repro_torch`` tree gates clean, the CLI
keeps the reference's exit codes and report, and the program verifier
holds its invariants on the cell suite on the CPU, with negative cases.
Parity with the reference, tolerance zero: the baseline file format,
the rule ids, and the ``fused``, ``stream`` and ``slab_wave`` cells
against the JAX package on the same numpy inputs."""

import ast
import dataclasses
import gc
import io
import json
import os
import subprocess
import sys
import textwrap
import tokenize

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import findings as jfindings
from repro.analysis import rules as jrules
from repro.core import incremental as jinc
from repro.core import parallel as jpar
from repro.launch import cells as jcells
from repro.serve import engine as jeng
from repro_torch.analysis import findings as tfindings
from repro_torch.analysis import rules as trules
from repro_torch.analysis.lint import collect_module, lint_paths
from repro_torch.analysis.verifier import HOST_OPS, verify_programs
from repro_torch.core import parallel as tpar
from repro_torch.core.dominance import SENTINEL
from repro_torch.launch.cells import (SKYLINE_CELLS, VERIFIER_EXTRA_CELLS,
                                      build_skyline_cell)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends (each
    keeps memory mappings of its machine code; see the port's other
    JAX-heavy test modules)."""
    yield
    jax.clear_caches()
    gc.collect()


def _write(tmp_path, rel, code):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(code))
    return str(path)


# one minimal violation per rule: (rule, relpath, source, violation line).
# The R1 and R5 fixtures sit at pipeline roots (rules.PIPELINE_ROOTS).
FIXTURES = {
    "R1": ("repro_torch/core/parallel.py", """\
        import torch


        def merge_stage(x):
            return helper(x)


        def helper(x):
            return torch.max(x).item() + 1
        """, 9),
    "R2": ("repro_torch/serve/packer.py", """\
        import torch


        def pack(items, device):
            out = []
            for it in items:
                out.append(torch.as_tensor(it).to(device=device))
            return out
        """, 7),
    "R3": ("repro_torch/serve/caller.py", """\
        from repro_torch.kernels.sfs.ops import sfs_sweep

        print(sfs_sweep)
        """, 1),
    "R4": ("repro_torch/serve/groups.py", """\
        import torch.distributed as dist

        print(dist)
        """, 1),
    "R5": ("repro_torch/core/incremental.py", """\
        import torch


        def _insert_batch(state, pts):
            if torch.any(pts > 0):
                return pts
            return -pts
        """, 5),
    "R6": ("repro_torch/serve/statefact.py", """\
        def update(state, x):
            return state._replace(points=state.points + x)
        """, 2),
}


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_each_rule_fires_exactly_on_its_fixture(tmp_path, rule):
    rel, code, line = FIXTURES[rule]
    path = _write(tmp_path, rel, code)
    findings = lint_paths([str(tmp_path)], repo_root=str(tmp_path))
    active = [f for f in findings if f.active]
    assert len(active) == 1, [str(f) for f in findings]
    f = active[0]
    assert f.rule == rule
    assert os.path.join(str(tmp_path), f.path) == path
    assert f.line == line
    assert f.hint  # every rule ships a fix-hint


def test_fixtures_do_not_cross_fire(tmp_path):
    """All fixtures together: one active finding per rule."""
    for rel, code, _ in FIXTURES.values():
        _write(tmp_path, rel, code)
    findings = [f for f in lint_paths([str(tmp_path)],
                                      repo_root=str(tmp_path)) if f.active]
    assert sorted(f.rule for f in findings) == sorted(FIXTURES)


def test_suppression_comment_same_line_and_line_above(tmp_path):
    rel, code, _ = FIXTURES["R1"]
    code = code.replace("return torch.max(x).item() + 1",
                        "return torch.max(x).item() + 1  # skylint: disable=R1")
    _write(tmp_path, rel, code)
    rel4, code4, _ = FIXTURES["R4"]
    code4 = code4.replace(
        "import torch.distributed as dist",
        "# the one sanctioned communicator of a vendored script\n"
        "        # skylint: disable=R4\n"
        "        import torch.distributed as dist", 1)
    _write(tmp_path, rel4, code4)
    findings = lint_paths([str(tmp_path)], repo_root=str(tmp_path))
    assert len(findings) == 2
    assert all(f.suppressed and not f.active for f in findings)
    # a suppression for a DIFFERENT rule does not cover the finding
    wrong = _write(tmp_path, "repro_torch/core/parallel.py", """\
        import torch


        def merge_stage(x):
            return torch.max(x).item() + 1  # skylint: disable=R2
        """)
    findings = lint_paths([wrong], repo_root=str(tmp_path))
    assert [f.rule for f in findings if f.active] == ["R1"]


def test_baseline_grandfathers_by_line_text(tmp_path):
    rel, code, _ = FIXTURES["R3"]
    _write(tmp_path, rel, code)
    first = lint_paths([str(tmp_path)], repo_root=str(tmp_path))
    bl = tmp_path / "baseline.json"
    assert tfindings.write_baseline(first, str(bl)) == 1
    again = lint_paths([str(tmp_path)], repo_root=str(tmp_path),
                       baseline_keys=tfindings.load_baseline(str(bl)))
    assert all(f.baselined and not f.active for f in again)
    # moving the offending line keeps it baselined (keyed on text)...
    _write(tmp_path, rel, "# a new leading comment\n"
           + textwrap.dedent(code))
    moved = lint_paths([str(tmp_path)], repo_root=str(tmp_path),
                       baseline_keys=tfindings.load_baseline(str(bl)))
    assert all(f.baselined for f in moved if f.rule == "R3")
    # ...but a CHANGED offending line goes stale and gates again
    _write(tmp_path, rel,
           "from repro_torch.kernels.dominance.ops import dominated_mask\n")
    stale = lint_paths([str(tmp_path)], repo_root=str(tmp_path),
                       baseline_keys=tfindings.load_baseline(str(bl)))
    assert [f.rule for f in stale if f.active] == ["R3"]


def test_clean_tree_passes():
    """The gate on the real tree: zero active findings, zero R1
    suppressions, an empty baseline, and a rationale beside every
    suppression directive."""
    findings = lint_paths([PORT], repo_root=ROOT)
    active = [f for f in findings if f.active]
    assert active == [], [str(f) for f in active]
    assert [str(f) for f in findings
            if f.suppressed and f.rule == "R1"] == []
    baseline = os.path.join(PORT, "analysis", "baseline.json")
    assert tfindings.load_baseline(baseline) == set()
    for dirpath, _, names in os.walk(PORT):
        for name in (n for n in names if n.endswith(".py")):
            path = os.path.join(dirpath, name)
            for line, why in _suppression_rationales(path):
                assert why, f"{path}:{line}: a suppression without rationale"


def _suppression_rationales(path):
    """(line, rationale) of every suppression comment in a file: the
    comment's own words before the directive, or the comment line
    above."""
    with open(path) as f:
        source = f.read()
    lines = source.splitlines()
    for tok in tokenize.generate_tokens(io.StringIO(source).readline):
        if tok.type != tokenize.COMMENT or "skylint:" not in tok.string:
            continue
        row = tok.start[0]
        said = tok.string.split("skylint:")[0].strip(" #")
        above = lines[row - 2].strip() if row > 1 else ""
        if not said and above.startswith("#") and "skylint:" not in above:
            said = above.strip(" #")
        yield row, said


def test_r3_repaired_core_reaches_kernels_through_the_packages():
    """core/ imports the kernels only through the families' package
    surface and the backend; the entries resolve to the same functions
    as the submodules define."""
    from repro_torch.kernels import dominance, sfs
    from repro_torch.kernels.dominance import ops as dops
    from repro_torch.kernels.dominance import ref as dref
    from repro_torch.kernels.sfs import ops as sops
    assert sfs.sfs_sweep is sops.sfs_sweep
    assert dominance.dominated_mask is dops.dominated_mask
    assert dominance.dominated_mask_ref is dref.dominated_mask_ref
    assert dominance.flush_subnormal is dref.flush_subnormal
    core = lint_paths([os.path.join(PORT, "core")], repo_root=ROOT)
    assert [f for f in core if f.rule == "R3"] == []
    # a fresh interpreter imports each entry first without a cycle
    for stmt in ("from repro_torch.kernels.sfs import sfs_sweep",
                 "from repro_torch.kernels.dominance import dominated_mask",
                 "import repro_torch.kernels.backend",
                 "import repro_torch.kernels.sfs.ops"):
        r = subprocess.run([sys.executable, "-c", stmt], env=dict(
            os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
            timeout=120)
        assert r.returncode == 0, (stmt, r.stderr)


def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=timeout)


def test_cli_exit_codes_and_json_report(tmp_path):
    """Non-zero exit + a JSON report naming rule and file:line on a
    violation; exit 0 on the clean tree (lint layer); the verify layer
    on the CPU reports the reference's keys; unknown cells are a usage
    error (2)."""
    rel, code, line = FIXTURES["R1"]
    path = _write(tmp_path, rel, code)
    report = tmp_path / "report.json"
    r = _cli("--layer", "lint", "--paths", str(tmp_path), "--json",
             str(report), "--baseline", str(tmp_path / "none.json"))
    assert r.returncode == 1, r.stdout + r.stderr
    data = json.loads(report.read_text())
    (f,) = [f for f in data["layers"]["lint"]["findings"]
            if not f["suppressed"]]
    assert set(f) == {"rule", "path", "line", "col", "message", "hint",
                      "snippet", "suppressed", "baselined"}
    assert f["rule"] == "R1" and f["line"] == line
    assert os.path.normpath(os.path.join(ROOT, f["path"])) == path
    assert not data["ok"]

    r = _cli("--layer", "lint")
    assert r.returncode == 0, r.stdout + r.stderr

    vreport = tmp_path / "verify.json"
    r = _cli("--layer", "verify", "--device", "cpu", "--cells",
             "sweep_p64", "slab_feed", "--json", str(vreport))
    assert r.returncode == 0, r.stdout + r.stderr
    data = json.loads(vreport.read_text())
    assert data["ok"] and set(data["layers"]) == {"verify"}
    v = data["layers"]["verify"]
    assert {"cells", "errors", "devices", "mem_cap", "smem_cap",
            "device"} <= set(v)
    assert set(v["cells"]) == {"sweep_p64", "slab_feed"}
    assert v["errors"] == [] and v["device"] == "cpu"

    r = _cli("--layer", "verify", "--device", "cpu", "--cells", "nope")
    assert r.returncode == 2, r.stdout + r.stderr


def test_lint_layer_imports_neither_torch_nor_jax():
    """The lint layer's files import no torch, jax or numpy, and the CLI's
    lint runs in an interpreter where importing them fails."""
    for name in ("lint.py", "rules.py", "findings.py", "__init__.py",
                 "__main__.py"):
        path = os.path.join(PORT, "analysis", name)
        with open(path) as f:
            tree = ast.parse(f.read())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
        mods |= {n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module
                 and not n.module.startswith("repro_torch.analysis")}
        assert not {m.split(".")[0] for m in mods} & \
            {"torch", "jax", "numpy", "repro"}, (name, mods)
    code = ("import sys\n"
            "for m in ('torch', 'jax', 'numpy'):\n"
            "    sys.modules[m] = None\n"
            "from repro_torch.analysis.__main__ import main\n"
            "sys.exit(main(['--layer', 'lint']))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=SRC),
                       cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 active" in r.stdout


def test_verify_runs_on_the_card_unless_asked(monkeypatch):
    """The device rule: without ``device="cpu"`` the verifier runs on the
    card, and without CUDA it raises; nothing falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        verify_programs(["sweep_p64"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_skyline_cell("sweep_p64", SKYLINE_CELLS["sweep_p64"],
                           smoke=True)


def test_scope_tables_resolve_to_functions():
    """Every qualname of HOT_PATHS, PIPELINE_ROOTS and PLAIN_VERSIONS
    names a function of the port, so a rename cannot make a rule
    vacuous."""
    tables = (trules.HOT_PATHS, trules.PIPELINE_ROOTS,
              trules.PLAIN_VERSIONS)
    for table in tables:
        for modname, quals in table.items():
            path = os.path.join(SRC, *modname.split(".")) + ".py"
            mod = collect_module(path, ROOT)
            assert mod.modname == modname
            have = {fn.qualname for fn in mod.functions}
            assert set(quals) <= have, (modname, set(quals) - have)
    assert set(trules.HOT_PATHS) == {m.replace("repro.", "repro_torch.")
                                     for m in jrules.HOT_PATHS}
    for modname, quals in jrules.HOT_PATHS.items():
        assert trules.HOT_PATHS[modname.replace("repro.",
                                                "repro_torch.")] == quals


def test_numpy_host_data_on_the_serving_paths_stays_clean(tmp_path):
    """False-positive guards: the numpy ``.tolist()`` and
    ``bool(np.any(...))`` of ``_wave_feed`` and ``tick`` are host data;
    the same calls on a tensor are host syncs."""
    _write(tmp_path, "repro_torch/serve/engine.py", """\
        import numpy as np
        import torch


        def _wave_feed(engine, parts):
            idx, heads = [], []
            for s, _, _ in parts:
                idx += s._idx().tolist()
                heads += s._head.tolist()
            expired = np.zeros(3, bool)
            return idx, heads, bool(np.any(expired & np.ones(3, bool)))


        class SkylineStream:
            def tick(self):
                sel = torch.arange(3) > 1
                return sel.tolist(), bool(sel.any())
        """)
    findings = lint_paths([str(tmp_path)], repo_root=str(tmp_path))
    assert [(f.rule, f.line) for f in findings] == [("R1", 17), ("R1", 17)]


def test_metadata_tests_in_core_are_not_branches_on_tensors(tmp_path):
    """False-positive guards for R5: isinstance, dtype, shape and
    ``is_floating_point`` tests and device/generator constructions read
    no device data; a test on a tensor's value does."""
    _write(tmp_path, "repro_torch/core/windowed.py", """\
        import torch


        def finalize(state, generator=None, device=None):
            v = torch.where(state.mask, state.count, 0)
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                v = v.float()
            if v.dtype == torch.float32 or v.shape[0] > 1 or v.ndim == 2:
                v = v + 1
            if torch.device(device or "cpu").type == "cuda":
                v = v * 2
            if generator is None:
                generator = torch.Generator(device=v.device).manual_seed(0)
            while v.numel() > 3 and v.dim() > 0:
                v = v[:1]
            return v if v.is_contiguous() else v.contiguous()


        def window_tick(state):
            v = state.count.sum()
            return 1 if torch.all(v > 0) else 0
        """)
    findings = lint_paths([str(tmp_path)], repo_root=str(tmp_path))
    assert [(f.rule, f.line) for f in findings] == [("R5", 21)]


def test_state_updates_honour_donation(tmp_path):
    """R6 in torch form: a state update that reads the flag and writes
    in place (or hands the flag on) passes; a leaves update writes in
    place; read-only overlays (new buffers out) are no updates; an
    update that ignores the flag, or leaves returned unwritten, fail."""
    _write(tmp_path, "repro_torch/core/ring.py", """\
        def advance(state, *, donate=True):
            if donate:
                state.head.copy_(state.head + 1)
                return state
            return state._replace(head=state.head + 1)


        def tick(state, cfg):
            return advance(state, donate=cfg.donate)


        def finalize(state, cfg):
            return SkyBuffer(state.points.clone(), state.mask.clone())


        def write_leaves(leaves, idx, vals):
            for a, v in zip(leaves, vals):
                a.index_copy_(0, idx, v)
            return leaves


        def blind(leaves):
            return leaves


        def no_flag(state, x):
            state.points.add_(x)
            return state
        """)
    findings = lint_paths([str(tmp_path)], repo_root=str(tmp_path))
    assert [(f.rule, f.message.split()[0]) for f in findings] == [
        ("R6", "blind"), ("R6", "no_flag")]


# --------------------------------------------------------------------------
# parity with the reference (tolerance zero)
# --------------------------------------------------------------------------

def test_baseline_files_are_byte_identical_to_the_reference(tmp_path):
    keys = [("R1", "src/x.py", "int(count.max())"),
            ("R3", "src/y.py", "from a.b import c"),
            ("R1", "src/x.py", "int(count.max())")]

    def findings(mod):
        return [mod.Finding(rule=r, path=p, line=1, col=0, message="m",
                            hint="h", snippet=s) for r, p, s in keys]

    mine, theirs = tmp_path / "port.json", tmp_path / "ref.json"
    assert tfindings.write_baseline(findings(tfindings), str(mine)) == 2
    assert jfindings.write_baseline(findings(jfindings), str(theirs)) == 2
    assert mine.read_bytes() == theirs.read_bytes()
    assert tfindings.load_baseline(str(theirs)) == \
        jfindings.load_baseline(str(mine)) == set(keys)
    with open(os.path.join(PORT, "analysis", "baseline.json"), "rb") as f:
        with open(os.path.join(SRC, "repro", "analysis",
                               "baseline.json"), "rb") as g:
            assert f.read() == g.read()


def test_rule_ids_match_the_reference():
    assert sorted(trules.RULES) == sorted(jrules.RULES)
    assert all(r.id == k and r.hint and r.rationale
               for k, r in trules.RULES.items())
    assert SKYLINE_CELLS == jcells.SKYLINE_CELLS
    assert VERIFIER_EXTRA_CELLS == jcells.VERIFIER_EXTRA_CELLS


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_leaves_equal(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{what} leaf {i}")


def _reference_cfg(built):
    """The cell's config as the reference's, at ``donate=False`` (the
    port's cell donates; the bits are the same)."""
    return jpar.SkyConfig(**dict(dataclasses.asdict(built.cfg),
                                 impl="perpair", donate=False))


def _keys(q):
    return jnp.zeros((q, 2), jnp.uint32)


def test_fused_cell_matches_the_reference():
    built = build_skyline_cell("fused_p512", SKYLINE_CELLS["fused_p512"],
                               smoke=True, device="cpu")
    buf, _ = built.fn(*built.args)
    pts, mask = built.host["chunk"]
    jbuf, _ = jpar.fused_skyline_batch_fn(_reference_cfg(built))(
        jnp.asarray(pts), jnp.asarray(mask), _keys(1))
    _assert_leaves_equal(tuple(buf), tuple(jbuf), "fused_p512")
    assert int(buf.count[0]) > 0


def test_stream_cell_matches_the_reference():
    built = build_skyline_cell("stream_8x64", SKYLINE_CELLS["stream_8x64"],
                               smoke=True, device="cpu")
    state, _ = built.fn(*built.args)
    jcfg = _reference_cfg(built)
    q, d = built.info["q"], built.info["d"]
    ins = jinc.insert_chunk_batch_fn(jcfg)
    jstate = jinc.init_state(jcfg, d, q=q)
    for pts, mask in (built.host["warm"], built.host["chunk"]):
        jstate, _ = ins(jstate, jnp.asarray(pts), jnp.asarray(mask),
                        _keys(q))
    _assert_leaves_equal(tuple(state), tuple(jstate), "stream_8x64")


def test_slab_wave_cell_matches_the_reference():
    """The chained wave: a warm-up wave, then the cell's wave with the
    warm-up's inserted states as its pending record, against the JAX
    engine's ``_slab_feed_fn`` (npend 0, then 1): arena, pending record
    and fits, bit for bit."""
    spec = VERIFIER_EXTRA_CELLS["slab_wave"]
    built = build_skyline_cell("slab_wave", spec, device="cpu")
    sub, fits, _ = built.fn(*built.args)
    arena = built.updated(None)
    jcfg = _reference_cfg(built)
    h = built.host
    q, rows, cap = spec["q"], spec["rows"], h["cap"]
    s, e, d = h["slots"], spec["epochs"], spec["d"]
    leaves = (jnp.full((s, e, rows, d), SENTINEL, jnp.float32),
              jnp.zeros((s, e, rows), jnp.bool_),
              jnp.zeros((s, e), jnp.int32), jnp.zeros((s, e), jnp.bool_),
              jnp.zeros((s, e), jnp.int32), jnp.zeros((s, e), jnp.int32))
    idx = jnp.arange(q, dtype=jnp.int32)
    heads = jnp.asarray(h["heads"], jnp.int32)
    warm = jeng._slab_feed_fn(jcfg, rows, q, None, "queries", "workers",
                              cap, 0)
    leaves, jsub, _, _ = warm(leaves, idx, heads,
                              *map(jnp.asarray, h["warm"]), _keys(q))
    wave = jeng._slab_feed_fn(jcfg, rows, q, None, "queries", "workers",
                              cap, 1)
    leaves, jsub2, jfits, _ = wave(
        leaves, idx, heads, *map(jnp.asarray, h["chunk"]), _keys(q),
        tuple(jsub), idx, jnp.ones((q,), jnp.bool_), heads)
    _assert_leaves_equal(arena, leaves, "slab_wave arena")
    _assert_leaves_equal(tuple(sub), tuple(jsub2), "slab_wave record")
    np.testing.assert_array_equal(fits.numpy(), np.asarray(jfits))


# --------------------------------------------------------------------------
# the program verifier on the CPU
# --------------------------------------------------------------------------

def test_program_verifier_invariants_hold_on_the_cpu():
    """Layer 2 over every cell: no host round-trips, no collectives,
    Q-independent operation counts, the slab boundary census, in-place
    state updates and the shared-memory cap; memory is not measured on
    the CPU and never reported as passed.  In a world of one the cells
    have no mesh: these are the one-device programs."""
    report, errors = verify_programs(device="cpu")
    assert errors == [], errors
    cells = report["cells"]
    assert set(cells) == set(SKYLINE_CELLS) | set(VERIFIER_EXTRA_CELLS)
    assert report["device"] == "cpu" and report["devices"] == 1
    for name, rec in cells.items():
        assert rec["host_ops"] == [], name
        assert rec["mesh"] is None, name
        assert rec["collectives"] == {}, name
        assert rec["memory"]["measured"] is False, name
        assert "graph" not in rec, name
        assert max(rec["smem"].values()) <= report["smem_cap"], name
        assert sum(rec["kernels"].values()) >= 1, name
    assert cells["engine_vmap"]["collectives"] == {}
    for name in ("batch_8x64", "stream_8x64", "window_8x64", "slab_wave"):
        assert cells[name]["op_count_q"] == cells[name]["op_count_2q"], name
    for name in ("stream_8x64", "window_8x64", "window_tick", "slab_feed",
                 "slab_wave"):
        assert cells[name]["inplace"], name
        assert all(v == {"kept": True, "written": True}
                   for v in cells[name]["inplace"].values()), name
    # the slab programs' edge never carries the full state capacity
    for name in ("slab_feed", "slab_wave"):
        spec = VERIFIER_EXTRA_CELLS[name]
        assert spec["capacity"] not in cells[name]["boundary_dims"]
        assert spec["rows"] in cells[name]["boundary_dims"]
    assert cells["stream_8x64"]["kernels"] == {"sfs_sweep": 2,
                                              "dominated_mask": 2}


@pytest.mark.parametrize("names", [
    ("tree_merge_p512", "fused_p512"),
    ("batch_8x64", "stream_8x64", "window_8x64", "window_tick", "slab_wave")])
def test_program_verifier_on_one_by_one_meshes(names):
    """``meshed=True`` builds the mesh cells on 1 x 1 meshes in a world of
    one: the invariants hold, the collectives run on the workers group,
    the tree cell runs ceil(log2 1) = 0 rounds, and the cells without a
    mesh stay without one."""
    report, errors = verify_programs(list(names) + ["engine_vmap"],
                                     device="cpu", meshed=True)
    assert errors == [], errors
    cells = report["cells"]
    assert cells["engine_vmap"]["mesh"] is None
    assert cells["engine_vmap"]["collectives"] == {}
    for name in names:
        rec = cells[name]
        assert rec["mesh"] == {"queries": 1, "workers": 1}, name
        assert rec["host_ops"] == [], name
        assert all(k.endswith("@workers") for k in rec["collectives"]), name
    if "tree_merge_p512" in cells:
        assert cells["tree_merge_p512"]["tree_rounds"] == \
            {"expected": 0, "ppermute": 0}
    for name in set(names) & {"batch_8x64", "stream_8x64", "window_8x64",
                              "slab_wave"}:
        assert cells[name]["op_count_q"] == cells[name]["op_count_2q"], name


def _wrapped_batch_fn(monkeypatch, wrap):
    """Replace the batched pipeline the ``batch``/``fused`` cells build
    with ``wrap(run)``."""
    orig = tpar.fused_skyline_batch_fn
    monkeypatch.setattr(tpar, "fused_skyline_batch_fn",
                        lambda cfg, mesh=None: wrap(orig(cfg, mesh)))


def test_a_deliberate_item_fails_the_host_op_check(monkeypatch):
    def wrap(run):
        def synced(pts, mask, generators=None):
            float(pts.sum())            # a host read in the program
            return run(pts, mask, generators)
        return synced

    _wrapped_batch_fn(monkeypatch, wrap)
    report, errors = verify_programs(["batch_8x64"], device="cpu")
    assert any("host round-trips" in e and "_local_scalar_dense" in e
               for e in errors), errors
    assert "aten::_local_scalar_dense" in \
        report["cells"]["batch_8x64"]["host_ops"]
    assert "aten::_local_scalar_dense" in HOST_OPS


def test_operations_growing_with_q_fail_q_independence(monkeypatch):
    def wrap(run):
        def per_query(pts, mask, generators=None):
            for i in range(pts.shape[0]):     # one run per query
                out = run(pts[i:i + 1], mask[i:i + 1], generators)
            return out
        return per_query

    _wrapped_batch_fn(monkeypatch, wrap)
    _, errors = verify_programs(["batch_8x64"], device="cpu")
    assert any("when Q doubled" in e for e in errors), errors


def test_stream_cell_without_donation_fails_the_in_place_check(
        monkeypatch):
    monkeypatch.setitem(SKYLINE_CELLS, "stream_8x64",
                        dict(SKYLINE_CELLS["stream_8x64"], donate=False))
    report, errors = verify_programs(["stream_8x64"], device="cpu")
    assert any("not updated in place" in e for e in errors), errors
    assert all(not v["kept"]
               for v in report["cells"]["stream_8x64"]["inplace"].values())


def test_a_d_above_the_shared_memory_law_fails_the_cap(monkeypatch):
    monkeypatch.setitem(VERIFIER_EXTRA_CELLS, "sweep_wide", dict(
        kind="sweep", n=256, d=64, p=4, capacity=512, block=512))
    report, errors = verify_programs(["sweep_wide"], device="cpu")
    assert report["cells"]["sweep_wide"]["smem"]["sweep"] > \
        report["smem_cap"]
    assert any("sweep kernel shared-memory law" in e and "exceeds" in e
               for e in errors), errors


def test_slab_cell_at_full_epoch_capacity_reports_c_at_its_boundary(
        monkeypatch):
    monkeypatch.setitem(VERIFIER_EXTRA_CELLS, "slab_feed", dict(
        VERIFIER_EXTRA_CELLS["slab_feed"], epoch_capacity=512))
    report, errors = verify_programs(["slab_feed"], device="cpu")
    assert errors == [], errors
    assert 512 in report["cells"]["slab_feed"]["boundary_dims"]


# --------------------------------------------------------------------------
# the verifier's collective checks on gloo worlds of four and eight
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    from _torch_world import World
    w = World(4, tmp_path_factory.mktemp("w4"))
    yield w
    w.close()


def test_collective_checks_hold_on_a_world_of_four(world4):
    """Every rank runs every cell it is a member of: collectives over the
    workers group only, the tree cell's exactly ceil(log2 4) = 2 rounds
    under its boundary bound, none in ``engine_vmap``, and the same
    collective count at q and 2q; the 2-D cells' query shards are
    assembled apart from the program."""
    out = world4.run("verify_cells", None)
    for r, (report, errors) in enumerate(out):
        assert errors == [], (r, errors)
        cells = report["cells"]
        assert report["devices"] == 4
        tree = cells["tree_merge_p512"]
        assert tree["mesh"] == {"queries": 1, "workers": 4}
        assert tree["tree_rounds"] == {"expected": 2, "ppermute": 2}
        assert 0 < tree["tree_boundary"]["max_operand"] <= \
            tree["tree_boundary"]["bound"]
        assert cells["engine_vmap"]["collectives"] == {}
        for name in ("batch_8x64", "stream_8x64", "window_8x64"):
            rec = cells[name]
            assert rec["mesh"] == {"queries": 2, "workers": 2}, name
            assert rec["collective_count_q"] == \
                rec["collective_count_2q"] > 0, name
            assert set(rec["assembled"]) == {"assemble@queries"}, name
        for name, rec in cells.items():
            assert all(k.endswith("@workers") for k in rec["collectives"])


@pytest.mark.parametrize("negative,match", [
    ("queries", "collectives over non-worker groups ['queries']"),
    ("round", "exactly ceil(log2(4)) = 2 ppermute rounds over workers, "
              "found 3"),
    ("flat", "above the tree-merge boundary bound")])
def test_collective_negative_cases_fail(world4, negative, match):
    """A collective on the queries group, a round too many, and the flat
    union in tree mode each fail the tree cell, on every rank."""
    out = world4.run("verify_cells", ["tree_merge_p512"], negative)
    for r, (_, errors) in enumerate(out):
        assert any(match in e for e in errors), (r, errors)


def test_verifier_cli_on_a_world_of_eight(tmp_path):
    """``--world 8`` spawns the gloo world and runs the census in every
    rank: the tree cell runs ceil(log2 8) = 3 rounds on each."""
    out = tmp_path / "v.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--layer", "verify",
         "--device", "cpu", "--world", "8", "--cells", "tree_merge_p512",
         "engine_vmap", "batch_8x64", "--json", str(out)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert r.returncode == 0, r.stdout + r.stderr
    report = json.loads(out.read_text())["layers"]["verify"]
    assert sorted(report["ranks"]) == [str(i) for i in range(8)]
    for rank, rec in report["cells"]["tree_merge_p512"].items():
        assert rec["tree_rounds"] == {"expected": 3, "ppermute": 3}, rank
    for rank, rec in report["cells"]["batch_8x64"].items():
        assert rec["mesh"] == {"queries": 2, "workers": 4}, rank

