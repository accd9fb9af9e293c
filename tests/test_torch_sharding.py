"""The port's sharding layer (``repro_torch.sharding``,
``models.common.plan_pspecs`` / ``placements`` / `Sharder`,
``train.step``'s sharded step, ``checkpoint.manager.restore(shardings=)``)
against the reference's (``repro.sharding``, ``repro.models.common``,
``tests/test_distributed.py``'s model cases).

What is held how:

| What | How it is held |
| --- | --- |
| ``arch_rules``, ``plan_pspecs`` and ``zero1_pspecs`` for the ten architectures x their shapes x both production meshes | exactly: the rules as dicts, each leaf's spec as the tuple of the reference's ``PartitionSpec`` entries |
| ``placements`` of those specs | exactly: ``Shard(dim)`` on every mesh axis the spec names for ``dim``, a tuple of axes major first, ``Replicate`` elsewhere |
| The sharded train step of yi-6b's smoke config on a 2 x 2 gloo world against the one-rank step (``test_distributed.py:84-126``) | the reference's own tolerances: loss 2e-3, parameters rtol 2e-2 and atol 2e-3; in f32 1e-4 |
| The sharded loss and gradients, f32, against the one-rank ones | loss 1e-4; each gradient leaf within 1e-4 of its largest element |
| The elastic restore onto a 2 x 2 mesh (``test_distributed.py:161-192``) | bit for bit, every rank's shard too |

One world of four ranks serves the module.
"""

import _torch_threads  # noqa: F401  (one torch thread)
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_world import World
from repro.configs import arch_rules as jarch_rules
from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.models.common import DEFAULT_RULES as JDEFAULT
from repro.models.common import plan_pspecs as jplan_pspecs
from repro.sharding import zero1_pspecs as jzero1
from repro_torch import convert
from repro_torch.checkpoint.manager import save
from repro_torch.configs import ARCH_NAMES, applicable_shapes, arch_rules
from repro_torch.configs import get_config
from repro_torch.launch.mesh import Replicate, Shard
from repro_torch.models import transformer as TT
from repro_torch.models.common import (DEFAULT_RULES, init_params,
                                       placements, plan_pspecs)
from repro_torch.sharding import zero1_pspecs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("sharding"))
    yield w
    w.close()


def _ref_specs(tree):
    """``{path: spec tuple}`` of a pytree of the reference's specs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(k.key for k in path): tuple(s) for path, s in flat}


def _port_specs(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_port_specs(tree[k], path + (k,)))
        return out
    return {path: tree}


def _mesh(multi_pod):
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return SimpleNamespace(mesh_dim_names=names, ndim=len(names))


def _expected_placements(spec, mesh):
    out = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                out[mesh.mesh_dim_names.index(a)] = Shard(dim)
    return tuple(out)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_and_placements_match_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    plan, jplan = TT.lm_plan(cfg), JT.lm_plan(jcfg)
    cells = 0
    for shape in applicable_shapes(cfg):
        for multi_pod in (False, True):
            rules = arch_rules(cfg, shape, multi_pod=multi_pod)
            jrules = jarch_rules(jcfg, shape, multi_pod=multi_pod)
            assert rules == jrules, (arch, shape, multi_pod)
            mesh = _mesh(multi_pod)
            got = _port_specs(plan_pspecs(plan, rules))
            want = _ref_specs(jplan_pspecs(jplan, jrules))
            assert got == want, (arch, shape, multi_pod)
            zgot = _port_specs(zero1_pspecs(plan, rules, 16))
            assert zgot == _ref_specs(jzero1(jplan, jrules, 16))
            for spec in list(got.values()) + list(zgot.values()):
                assert placements(spec, mesh) == \
                    _expected_placements(spec, mesh), spec
            cells += 1
    assert cells == 2 * len(applicable_shapes(cfg))
    assert _port_specs(plan_pspecs(plan)) == \
        _ref_specs(jplan_pspecs(jplan, JDEFAULT))


def test_zero1_specs_add_data_axis():
    """Mirror of ``tests/test_train_infra.py::test_zero1_specs_add_data_axis``."""
    plan = TT.lm_plan(get_config("yi-6b"))
    specs = _port_specs(zero1_pspecs(plan, DEFAULT_RULES, 16))
    emb = [v for k, v in specs.items() if "embed" in "/".join(k).lower()][0]
    assert "data" in str(emb)  # moments got an extra data-axis shard


def test_placements_follow_the_mesh_order():
    mesh = _mesh(True)
    assert placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements((None,), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="not in the mesh"):
        placements(("pod",), _mesh(False))
    with pytest.raises(ValueError, match="twice"):
        placements(("model", "model"), mesh)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sharded_train_step_matches_one_rank(world, dtype):
    """Same batch, same init: a (2 data x 2 model) sharded train step
    gives the one-rank step's loss and parameters."""
    kw = {} if dtype == "bfloat16" else {"compute_dtype": "float32"}
    loss1, loss2, p1, p2, placed = world.run(
        "sharded_train_step", "yi-6b", 2, 2, kw, deadline=240)[0]
    if dtype == "bfloat16":
        assert abs(loss1 - loss2) < 2e-3, (loss1, loss2)
        rtol, atol = 2e-2, 2e-3
    else:
        assert abs(loss1 - loss2) < 1e-4, (loss1, loss2)
        rtol, atol = 1e-4, 1e-4
    assert p1.keys() == p2.keys()
    for k in p1:
        np.testing.assert_allclose(p2[k], p1[k], rtol=rtol, atol=atol,
                                   err_msg=k)
    # the weights really were sharded over the model axis
    assert "Shard(dim=2)" in placed["/blocks/mlp/wi"]
    assert "Shard(dim=0)" in placed["/embed"]


def test_sharded_gradients_match_one_rank(world):
    """f32: the loss and every gradient of a (2 data x 2 model) sharded
    forward and backward against the one-rank ones, each leaf within
    1e-4 of its largest element (the first AdamW step is sign-like, so
    the parameters after it do not show a gradient's size)."""
    loss1, loss2, grads = world.run("sharded_gradients", "yi-6b", 2, 2,
                                    {"compute_dtype": "float32"},
                                    deadline=240)[0]
    assert abs(loss1 - loss2) < 1e-4, (loss1, loss2)
    for k, (one, two) in grads.items():
        bound = 1e-4 * float(np.abs(one).max())
        assert float(np.abs(two - one).max()) <= bound, k


def test_elastic_restore_across_topology(world, tmp_path):
    """Saved from one process, restored sharded onto a 2 x 2 mesh: every
    leaf's bits, whole and on each rank's shard."""
    cfg = get_config("yi-6b", smoke=True)
    params = init_params(TT.lm_plan(cfg), seed=0, device="cpu")
    save(str(tmp_path), 1, params)
    host = convert.params_to_numpy(params)
    ranks = world.run("elastic_restore", "yi-6b", str(tmp_path),
                      deadline=120)
    want = {"/" + "/".join(k): v for k, v in _port_specs(host).items()}
    coords = set()
    sharded = 0
    for whole, local, placed, coord in ranks:
        coords.add(tuple(coord))
        assert whole.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(whole[k].view(np.uint8),
                                          want[k].view(np.uint8), err_msg=k)
            np.testing.assert_array_equal(
                local[k].view(np.uint8),
                _shard(want[k], placed[k], coord).view(np.uint8), err_msg=k)
            sharded += "Shard" in placed[k]
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}
    assert sharded > 0


def _shard(arr, placed: str, coord) -> np.ndarray:
    """The block of ``arr`` at mesh ``coord`` of a 2 x 2 mesh under the
    placements written as ``placed`` (``torch.chunk``'s blocks)."""
    t = torch.from_numpy(arr)
    for i, p in enumerate(placed.strip("()").split("), ")):
        if p.startswith("Shard"):
            dim = int(p.split("dim=")[1].rstrip(")"))
            t = torch.chunk(t, 2, dim=dim)[coord[i]]
    return t.contiguous().numpy()
