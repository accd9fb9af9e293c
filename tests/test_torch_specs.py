"""The dry run's stand-ins (``repro_torch.models.common.abstract_params``,
``repro_torch.launch.specs``: ``input_specs``, ``cache_specs``,
``state_specs``) against the reference's (``repro.launch.specs``), for
the ten architectures at their published widths x their shapes x both
production meshes.

What is held how:

| What | How it is held |
| --- | --- |
| Every leaf's global shape and dtype | exactly |
| Rank 0's local shard shape | exactly: the port's DTensor local shard on a fake world of 256 (512) ranks against the reference's ``NamedSharding.shard_shape`` on an ``AbstractMesh`` of the same axes |
| ``abstract_params`` without a mesh | meta tensors of the plan's shapes and dtypes, no storage |

The port's side runs in one subprocess (a fake world needs a process
without a world of its own); the reference's in this process, with no
device.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import json
import os
import subprocess
import sys

import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import arch_rules as jarch_rules
from repro.configs import get_config as jget
from repro.launch import specs as jspecs
from repro_torch.configs import ARCH_NAMES, SHAPES, applicable_shapes
from repro_torch.configs import get_config
from repro_torch.models import transformer as TT
from repro_torch.models.common import abstract_params, plan_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the port's side: {arch/shape/mesh/kind/leaf: [shape, dtype, local shape]}
_PORT = """
import json, sys, torch
torch.set_num_threads(1)
from repro_torch.configs import ARCH_NAMES, applicable_shapes, arch_rules
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.specs import cache_specs, input_specs, state_specs
from repro_torch.models.attention import KVCache

def flat(tree, path, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            flat(tree[k], f"{path}/{k}", out)
    elif isinstance(tree, KVCache):
        for k in ("k", "v", "kpos"):
            flat(getattr(tree, k), f"{path}/{k}", out)
    elif isinstance(tree, tuple):
        for k in tree._fields:
            flat(getattr(tree, k), f"{path}/{k}", out)
    else:
        out[path] = [list(tree.shape), str(tree.dtype).split(".")[-1],
                     list(tree.to_local().shape)]

out = {}
for multi_pod in (False, True):
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        for arch in ARCH_NAMES:
            cfg = get_config(arch)
            for shape in applicable_shapes(cfg):
                rules = arch_rules(cfg, shape, multi_pod=multi_pod)
                key = f"{arch}/{shape}/{int(multi_pod)}"
                flat(state_specs(cfg, mesh, rules), key + "/state", out)
                flat(input_specs(cfg, shape, mesh, rules), key + "/in", out)
                if SHAPES[shape].kind == "decode":
                    flat(cache_specs(cfg, shape, mesh, rules),
                         key + "/cache", out)
json.dump(out, open(sys.argv[1], "w"))
"""


def _flat(tree, path, out):
    """The reference's stand-ins, keyed as ``_PORT`` keys the port's."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(tree[k], f"{path}/{k}", out)
    elif type(tree).__name__ == "KVCache":
        for k in ("k", "v", "kpos"):
            _flat(getattr(tree, k), f"{path}/{k}", out)
    elif isinstance(tree, tuple):
        for k in tree._fields:
            _flat(getattr(tree, k), f"{path}/{k}", out)
    else:
        out[path] = [list(tree.shape), str(tree.dtype),
                     list(tree.sharding.shard_shape(tree.shape))]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    dst = tmp_path_factory.mktemp("specs") / "port.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _PORT, str(dst)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(dst.read_text())


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_match_reference(arch, port):
    jcfg = jget(arch)
    want = {}
    for multi_pod in (False, True):
        mesh = AbstractMesh((2, 16, 16) if multi_pod else (16, 16),
                            ("pod", "data", "model") if multi_pod
                            else ("data", "model"))
        for shape in applicable_shapes(get_config(arch)):
            rules = jarch_rules(jcfg, shape, multi_pod=multi_pod)
            key = f"{arch}/{shape}/{int(multi_pod)}"
            _flat(jspecs.state_specs(jcfg, mesh, rules), key + "/state", want)
            _flat(jspecs.input_specs(jcfg, shape, mesh, rules), key + "/in",
                  want)
            if SHAPES[shape].kind == "decode":
                _flat(jspecs.cache_specs(jcfg, shape, mesh, rules),
                      key + "/cache", want)
    got = {k: v for k, v in port.items() if k.startswith(arch + "/")}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k


def test_abstract_params_hold_no_memory():
    cfg = get_config("llama4-maverick-400b-a17b")
    plan = TT.lm_plan(cfg)
    params = abstract_params(plan, dtype=torch.bfloat16)
    leaves = dict(plan_leaves(plan))
    flat = {}

    def walk(t, path=()):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], path + (k,))
        else:
            flat[path] = t

    walk(params)
    assert flat.keys() == leaves.keys()
    for path, t in flat.items():
        assert t.is_meta and t.dtype == torch.bfloat16
        assert tuple(t.shape) == leaves[path].shape
