"""The distributed MoE dispatch of the port (``models.moe.moe_apply``
with an enabled sharder: routing, dispatch and combine per token shard
under ``local_map``) against the reference's distributed ``moe_apply``
(dispatch and combine per data shard under ``shard_map``), each on a
2 x 2 (data, model) mesh: the reference on four forced host devices in
a subprocess, the port on a gloo world of four ranks.

What is held how:

| What | How it is held |
| --- | --- |
| The layer's output and aux terms, f32, for the MoE layers of mixtral's and llama4's smoke configs (llama4's with its shared expert) | 1e-4, the reference's f32 tolerance |
| The dispatch buffers, each choice's destination row and whether it was kept, per token shard | exactly |

Each shard has its own capacity, so the distributed layer drops other
tokens than the one-device layer; it is held against the reference's
distributed layer only.  The port takes the reference's routing
choices (recorded in the subprocess), as the one-device MoE tests do,
so that the dispatch is compared on the same choices.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from _torch_models import F32_TOL
from _torch_world import World
from repro_torch import convert
from repro_torch.configs import arch_rules, get_config
from repro_torch.models import moe as tmoe
from repro_torch.models.common import init_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["mixtral-8x7b", "llama4-maverick-400b-a17b"]
B, S = 4, 16

# the reference's distributed layer on a 2 x 2 mesh of forced devices:
# argv = (npz of inputs, out npz); records the shard_map bodies' outputs
_REFERENCE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from repro.compat import set_mesh
from repro.configs import arch_rules, get_config
from repro.launch.mesh import make_local_mesh
from repro.models import moe as jmoe
from repro.models.common import Sharder
assert len(jax.devices()) == 4
src, dst = sys.argv[1], sys.argv[2]
inp = dict(np.load(src, allow_pickle=True))
out = {}
for arch in json.loads(str(inp["archs"])):
    cfg = get_config(arch, smoke=True)
    rules = arch_rules(cfg, "train_4k", model_axis=2, data_axis=2)
    params = {k[len(arch) + 1:]: jnp.asarray(v) for k, v in inp.items()
              if k.startswith(arch + ":")}
    tree = {}
    for k, v in params.items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    seen, routes = [], []
    orig_sm, orig_topk = jmoe.shard_map, jax.lax.top_k

    def shard_map(fn, **kw):
        inner = orig_sm(fn, **kw)
        def call(*a):
            r = inner(*a)
            seen.append(r)
            return r
        return call

    def top_k(x, k):
        r = orig_topk(x, k)
        routes.append(r[1])
        return r

    jmoe.shard_map, jax.lax.top_k = shard_map, top_k
    mesh = make_local_mesh(2, 2)
    with set_mesh(mesh):
        def f(p, x):
            y, aux = jmoe.moe_apply(p, x, n_experts=cfg.n_experts,
                                    top_k=cfg.top_k,
                                    capacity_factor=cfg.capacity_factor,
                                    compute_dtype=jnp.float32,
                                    sharder=Sharder(rules, enabled=True))
            return y, aux, seen[0], routes[0]
        y, aux, (buf, dest, ok), idx = jax.jit(f)(tree, jnp.asarray(
            inp[arch + "/x"]))
    jmoe.shard_map, jax.lax.top_k = orig_sm, orig_topk
    for name, v in (("y", y), ("buf", buf), ("dest", dest), ("ok", ok),
                    ("idx", idx)):
        out[f"{arch}/{name}"] = np.asarray(v)
    for name, v in aux.items():
        out[f"{arch}/aux/{name}"] = np.asarray(v)
np.savez(dst, **out)
print("OK")
"""


def _layer(arch):
    cfg = get_config(arch, smoke=True)
    plan = tmoe.moe_plan(cfg.d_model, cfg.d_ff, cfg.n_experts,
                         cfg.shared_expert)
    return cfg, convert.params_to_numpy(init_params(plan, seed=5,
                                                    device="cpu"))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's results for both layers, one subprocess."""
    tmp = tmp_path_factory.mktemp("moe_ref")
    inputs = {"archs": json.dumps(ARCHS)}
    rng = np.random.default_rng(7)
    for arch in ARCHS:
        cfg, host = _layer(arch)
        for k, v in _flat(host).items():
            inputs[f"{arch}:{k}"] = v
        inputs[f"{arch}/x"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                        str(tmp / "in.npz"), str(tmp / "out.npz")],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-4000:]
    return dict(np.load(tmp / "in.npz")), dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("moe_world"))
    yield w
    w.close()


@pytest.mark.parametrize("arch", ARCHS)
def test_distributed_moe_matches_reference(arch, reference, world):
    inp, ref = reference
    cfg, host = _layer(arch)
    rules = arch_rules(cfg, "train_4k", model_axis=2, data_axis=2)
    assert rules["batch"] == ("data",)
    ranks = world.run("distributed_moe", arch, host, inp[f"{arch}/x"],
                      ref[f"{arch}/idx"], rules, deadline=120)
    y, aux = ranks[0][0], ranks[0][1]
    np.testing.assert_allclose(y, ref[f"{arch}/y"], rtol=F32_TOL,
                               atol=F32_TOL)
    for k, v in aux.items():
        np.testing.assert_allclose(v, ref[f"{arch}/aux/{k}"], rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=k)
    # the token shards in data order, from the ranks of model index 0
    shards = sorted((r[-1][0], r) for r in ranks if r[-1][1] == 0)
    buf = np.concatenate([r[2] for _, r in shards], axis=1)
    dest = np.concatenate([r[3] for _, r in shards])
    ok = np.concatenate([r[4] for _, r in shards])
    np.testing.assert_array_equal(buf.view(np.uint32),
                                  ref[f"{arch}/buf"].view(np.uint32))
    np.testing.assert_array_equal(dest, ref[f"{arch}/dest"])
    np.testing.assert_array_equal(ok, ref[f"{arch}/ok"])
    # per-shard capacity: the buffer holds two shards of cap_l slots
    t_l = B * S // 2
    cap_l = max(1, int(cfg.capacity_factor * t_l * cfg.top_k
                       / cfg.n_experts))
    assert buf.shape == (cfg.n_experts, 2 * cap_l, cfg.d_model)
