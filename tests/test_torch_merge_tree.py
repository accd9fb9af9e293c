"""The port's multi-device merge against the JAX package's mesh path.

Tolerance zero: every leaf (points, mask, count, overflow) compared as
raw bits, ``-0.0`` kept.  The port runs in one gloo world of eight CPU
ranks (`_torch_world.World`), its meshes on a prefix of the ranks; the
reference runs in one JAX subprocess with eight forced host devices,
its meshes on the same prefix of the devices (the ``_run`` pattern of
``tests/test_merge_tree.py``), on the same arrays.  Worlds of W in
{1, 2, 3, 4, 6, 8} (3 and 6 are not powers of two), the flat and tree
merges, the sequential merge and NoSeq, the four strategies (the
random strategy takes the reference's ids, ROADMAP.md contract 5) and
``rep_filter='sorted'``, on tie-heavy lattice data with ``-0.0``.
Outside overflow each mesh answer is also the port's one-device answer;
the overflow cases, where the tree truncates otherwise than the flat
merge, are held against the reference's tree bits.  Chunked inserts on
a mesh (one state on six workers; Q = 4 and 8 states on 2 x 2 and
2 x 4 meshes, the 2-D batch) equal the reference's chunked inserts on
the same mesh, and their one-shot answer the reference's
``parallel_skyline`` or ``fused_skyline_batch_fn`` on that mesh; a window
fed on a mesh equals the reference's window leaf by leaf."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from _torch_world import World

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORLD = 8

BASE = dict(capacity=512, block=64, bucket_factor=10.0)


def _case(w, strategy, p, merge, noseq=False, rep=None, data=(3, 420, 3, 9),
          **kw):
    cfg = dict(BASE, strategy=strategy, p=p, merge=merge, noseq=noseq, **kw)
    if rep:
        cfg["rep_filter"] = rep
    if strategy == "grid":
        cfg["m"] = 2
    if strategy == "angular":
        cfg["m"] = 3 if p % 3 == 0 else 4
    return {"w": w, "cfg": cfg, "data": list(data)}


def _cases():
    out = []
    # eight workers: every strategy under the tree merge, with the
    # representative filter, sequential and NoSeq; the flat merge once
    for noseq in (False, True):
        for strat, p in (("sliced", 16), ("random", 16), ("grid", 8),
                         ("angular", 16)):
            out.append(_case(8, strat, p, "tree", noseq, rep="sorted",
                             data=(3, 600, 3, 12)))
        out.append(_case(8, "sliced", 16, "flat", noseq, rep="sorted",
                         data=(3, 600, 3, 12)))
    # six and three workers (not powers of two), four, two and one
    out += [_case(6, "sliced", 12, "tree", False, data=(7, 540, 3, 9)),
            _case(6, "sliced", 12, "tree", True, data=(7, 540, 3, 9)),
            _case(6, "random", 12, "flat", True, data=(7, 540, 3, 9)),
            _case(3, "angular", 9, "tree", False, data=(5, 360, 3, 9)),
            _case(3, "angular", 9, "tree", True, data=(5, 360, 3, 9)),
            _case(4, "grid", 8, "tree", False, data=(4, 400, 3, 5)),
            _case(4, "grid", 8, "tree", True, data=(4, 400, 3, 5)),
            _case(2, "sliced", 4, "tree", True, rep="sorted",
                  data=(2, 300, 4, 16)),
            _case(2, "sliced", 4, "flat", False, data=(2, 300, 4, 16)),
            _case(1, "random", 4, "tree", False, data=(1, 200, 3, 9)),
            _case(1, "random", 4, "tree", True, data=(1, 200, 3, 9))]
    # overflow: a capacity below the union, where the tree truncates
    # otherwise than the flat merge
    out += [_case(3, "sliced", 12, "tree", False, data=(9, 900, 4, 40),
                  capacity=24, block=8),
            _case(4, "sliced", 12, "tree", True, data=(9, 900, 4, 40),
                  capacity=24, block=8)]
    return out


CASES = _cases()

_REFERENCE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.compat import make_mesh
from repro.core import SkyConfig, parallel_skyline
from repro.core import incremental as inc, windowed as win
from repro.core.datagen import generate
from repro.core.partition import random_part_ids
from repro.core.parallel import effective_parts, fused_skyline_batch_fn
from repro.launch.mesh import make_engine_mesh

spec = json.load(open(sys.argv[1]))
out = {}

def data(seed, n, d, quant):
    pts = generate("anticorrelated", jax.random.PRNGKey(seed), n, d)
    pts = np.array(jnp.round(pts * quant) / quant)
    # signed zeros: every third zero of the lattice made negative
    z = np.flatnonzero(pts.reshape(-1) == 0)[::3]
    pts.reshape(-1)[z] = -0.0
    return pts

def mesh(w):
    return make_mesh((w,), ("workers",), devices=jax.devices()[:w])

for i, c in spec["cases"]:
    pts = data(*c["data"])
    cfg = SkyConfig(**c["cfg"])
    buf, _ = parallel_skyline(jnp.asarray(pts), cfg=cfg, mesh=mesh(c["w"]))
    out[f"{i}/pts"] = pts
    for k, leaf in zip("pmco", buf):
        out[f"{i}/{k}"] = np.asarray(leaf)
    if cfg.strategy == "random":
        p, _ = effective_parts(cfg, pts.shape[1])
        out[f"{i}/ids"] = np.asarray(random_part_ids(jax.random.PRNGKey(0),
                                                     pts.shape[0], p))

# chunked inserts on a mesh, and the one-shot answer on it: one state on
# a workers mesh, or Q states on a (queries x workers) mesh
for j, s in spec["streams"]:
    base = data(*s["data"])
    cfg = SkyConfig(**s["cfg"])
    if s["qa"]:
        pts = np.stack([base[slice(*sl)] for sl in s["slices"]])
        m = make_engine_mesh(s["qa"], s["w"] // s["qa"])
        keys = jax.random.split(jax.random.PRNGKey(0), pts.shape[0])
        one, _ = fused_skyline_batch_fn(cfg, m)(
            jnp.asarray(pts), jnp.ones(pts.shape[:2], bool), keys)
        st = inc.init_state(cfg, pts.shape[-1], q=pts.shape[0])
        for lo in range(0, pts.shape[1], s["chunk"]):
            st, _ = inc.insert_chunk(
                st, jnp.asarray(pts[:, lo:lo + s["chunk"]]), cfg=cfg, mesh=m)
    else:
        pts = base[slice(*s["slices"][0])]
        m = mesh(s["w"])
        one, _ = parallel_skyline(jnp.asarray(pts), cfg=cfg, mesh=m)
        st = inc.init_state(cfg, pts.shape[-1])
        for lo in range(0, pts.shape[0], s["chunk"]):
            st, _ = inc.insert_chunk(
                st, jnp.asarray(pts[lo:lo + s["chunk"]]), cfg=cfg, mesh=m)
    out[f"s{j}/pts"] = pts
    for k, (a, b) in enumerate(zip(one, inc.finalize(st, cfg=cfg))):
        out[f"s{j}/one/{k}"] = np.asarray(a)
        out[f"s{j}/fin/{k}"] = np.asarray(b)

# a window fed on a mesh, leaf by leaf after every insert
w = spec["window"]
if w:
    cfg = SkyConfig(**w["cfg"])
    pts = data(*w["data"])
    st = win.init_window_state(cfg, pts.shape[1], epochs=w["epochs"])
    for j in range(w["chunks"]):
        lo = j * w["rows"]
        st, _ = win.insert_chunk(st, jnp.asarray(pts[lo:lo + w["rows"]]),
                                 cfg=cfg, mesh=mesh(w["w"]))
        for k, leaf in enumerate(st):
            out[f"win/{j}/{k}"] = np.asarray(leaf)
        if j in w["advance_after"]:
            st, _ = win.advance_epoch(st)
    out["win/pts"] = pts
    for k, leaf in enumerate(win.finalize(st, cfg=cfg)):
        out[f"win/final/{k}"] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
print("OK")
"""

# (id, workers, queries size or 0 for a 1-D mesh, row slices of the
# data; one per state on a 2-D mesh); 270 or 540 rows, chunks of 90
_Q8 = [[0, 270, 1], [270, 540, 1], [135, 405, 1], [269, None, -1],
       [67, 337, 1], [539, 269, -1], [200, 470, 1], [0, 540, 2]]
STREAMS = [("6-0", 6, 0, [[0, 540, 1]]),
           ("4-2", 4, 2, _Q8[:4]),
           ("4-2-q8", 4, 2, _Q8),
           ("8-2-q4", 8, 2, _Q8[:4]),
           ("8-2", 8, 2, _Q8)]
STREAM_SPEC = [[j, {"w": w, "qa": qa, "slices": sl, "chunk": 90,
                    "data": [3, 600, 3, 12],
                    "cfg": dict(BASE, strategy="sliced", p=8 if qa else 12,
                                merge="tree")}]
               for j, (_, w, qa, sl) in enumerate(STREAMS)]

WINDOW = {"w": 4, "epochs": 3, "rows": 150, "chunks": 5,
          "advance_after": [1, 3], "data": [6, 750, 3, 9],
          "cfg": dict(BASE, strategy="sliced", p=8, merge="tree",
                      donate=False)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(WORLD, tmp_path_factory.mktemp("world"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def reference(world, tmp_path_factory):
    """The reference's answers, from three JAX subprocesses (half the
    cases each, and the chunked inserts; the world's ranks starting
    meanwhile)."""
    tmp = tmp_path_factory.mktemp("ref")
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={WORLD}"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    procs = []
    for part in range(3):
        spec = tmp / f"spec{part}.json"
        spec.write_text(json.dumps({
            "cases": [[i, c] for i, c in enumerate(CASES) if i % 2 == part],
            "streams": STREAM_SPEC if part == 2 else [],
            "window": WINDOW if part == 1 else None}))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(_REFERENCE), str(spec),
             str(tmp / f"ref{part}.npz")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env))
    out = {}
    for part, proc in enumerate(procs):
        try:
            stdout, stderr = proc.communicate(timeout=300)
        finally:
            proc.kill()
        assert proc.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
        out.update(np.load(tmp / f"ref{part}.npz"))
    return out


def _bits(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_leaves(got, want, what):
    for k, g, w in zip("pmco", got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{what}: leaf {k}")


def _ref_leaves(ref, i):
    return [ref[f"{i}/{k}"] for k in "pmco"]


@pytest.fixture(scope="module")
def mesh_answers(world, reference):
    """Every case run on its prefix mesh in the world, in one task per
    world size."""
    out = {}
    for w in sorted({c["w"] for c in CASES}):
        idx = [i for i, c in enumerate(CASES) if c["w"] == w]
        args = [{"pts": reference[f"{i}/pts"], "cfg": CASES[i]["cfg"],
                 "ids": ([reference[f"{i}/ids"]]
                         if f"{i}/ids" in reference else [])}
                for i in idx]
        ranks = world.run("skyline_cases", w, args)
        for r in range(w):
            assert len(ranks[r]) == len(idx)
        for r in range(w, WORLD):
            assert ranks[r] is None
        for j, i in enumerate(idx):
            out[i] = [ranks[r][j] for r in range(w)]
    return out


@pytest.mark.parametrize("i", range(len(CASES)), ids=[
    f"W{c['w']}-{c['cfg']['strategy']}-{c['cfg']['merge']}"
    f"{'-noseq' if c['cfg']['noseq'] else ''}"
    f"{'-rep' if c['cfg'].get('rep_filter') else ''}"
    f"{'-overflow' if c['cfg']['capacity'] < 100 else ''}"
    for c in CASES])
def test_mesh_matches_reference_mesh(i, mesh_answers, reference):
    """Every rank of the mesh holds the reference's mesh answer; outside
    overflow it is also the port's one-device answer."""
    want = _ref_leaves(reference, i)
    for r, (mesh_leaves, one_device) in enumerate(mesh_answers[i]):
        _assert_leaves(mesh_leaves, want, f"rank {r}")
        if not bool(want[3]):
            _assert_leaves(one_device, want, f"one device, rank {r}")
    assert bool(want[3]) == (CASES[i]["cfg"]["capacity"] < 100)


def test_overflow_cases_truncate_otherwise_than_flat(mesh_answers,
                                                     reference):
    """The overflow cases are real: the tree's truncated buffer is not
    the flat merge's (which the port's one-device run computes)."""
    idx = [i for i, c in enumerate(CASES) if c["cfg"]["capacity"] < 100]
    differ = 0
    for i in idx:
        mesh_leaves, flat = mesh_answers[i][0]
        differ += not np.array_equal(_bits(mesh_leaves[0]), _bits(flat[0]))
    assert differ >= 1


@pytest.mark.parametrize("j", range(len(STREAMS)),
                         ids=[s[0] for s in STREAMS])
def test_chunked_inserts_on_mesh_equal_one_shot(world, reference, j):
    """Chunked inserts on a mesh finalize to the reference's chunked
    inserts on the same mesh, and to the one-shot answer there, bit for
    bit; the one-shot answer is the reference's (``parallel_skyline`` on
    six workers, ``fused_skyline_batch_fn`` for Q = 4 and 8 states on
    2 x 2 and 2 x 4 meshes) and the port's one-device answer."""
    _, w, qa, _ = STREAMS[j]
    pts = reference[f"s{j}/pts"]
    want_one = [reference[f"s{j}/one/{k}"] for k in range(4)]
    want_fin = [reference[f"s{j}/fin/{k}"] for k in range(4)]
    assert not want_one[3].any()
    out = world.run("stream_case", w, pts, 90, STREAM_SPEC[j][1]["cfg"], qa)
    for r in range(w):
        one, fin, solo = out[r]
        _assert_leaves(one, want_one, f"one-shot, rank {r}")
        _assert_leaves(fin, want_fin, f"chunked, rank {r}")
        _assert_leaves(solo, want_one, f"one device, rank {r}")
        np.testing.assert_array_equal(_bits(one[0]), _bits(fin[0]))
        np.testing.assert_array_equal(one[1], fin[1])
        np.testing.assert_array_equal(one[2], fin[2])
    for r in range(w, WORLD):
        assert out[r] is None


def test_window_on_mesh_matches_reference(world, reference):
    """A window fed on a four-worker mesh under the tree merge: every
    leaf after every insert, and the merge-on-read snapshot, equal the
    reference's."""
    pts = reference["win/pts"]
    rows = WINDOW["rows"]
    chunks = [pts[j * rows:(j + 1) * rows] for j in range(WINDOW["chunks"])]
    out = world.run("window_case", WINDOW["w"], chunks, WINDOW["epochs"],
                    WINDOW["cfg"], WINDOW["advance_after"])
    for r in range(WINDOW["w"]):
        trace, final, _ = out[r]
        for j, leaves in enumerate(trace):
            for k, leaf in enumerate(leaves):
                np.testing.assert_array_equal(
                    _bits(leaf), _bits(reference[f"win/{j}/{k}"]),
                    err_msg=f"rank {r}, insert {j}, leaf {k}")
        for k, leaf in enumerate(final):
            np.testing.assert_array_equal(
                _bits(leaf), _bits(reference[f"win/final/{k}"]),
                err_msg=f"rank {r}, snapshot leaf {k}")
