"""GPipe (`repro_torch.train.pipeline`) against sequential layers and
against ``repro.train.pipeline`` (``tests/test_pipeline.py``'s case:
S = 4 stages, L = 8 layers of ``tanh(x @ w)``, M = 6 microbatches of
B = 2 rows, D = 16), on a gloo world of four CPU ranks.

* Every rank returns the same outputs, bit for bit.
* Against the sequential layers and against the reference's
  ``gpipe_forward`` (one JAX subprocess with four forced host devices,
  started while the world's ranks start): rtol = atol = 2e-5, the
  reference's own tolerance (``tanh`` and the products differ between
  XLA and torch).
* Outputs of -0.0 on the last stage: +0.0 on every rank with two stages
  or more (the reference's psum adds the other stages' zeros), -0.0 with
  one (a psum over one device is a copy), bit for bit the reference's on
  four stages.
* ``pipeline_stages`` bit for bit.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_world import World
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.train.pipeline import gpipe_forward, pipeline_stages

ROOT = os.path.join(os.path.dirname(__file__), "..")
S, L, M, B, D = 4, 8, 6, 2, 16

_REFERENCE = """
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import make_mesh, shard_map
    from repro.train.pipeline import gpipe_forward, pipeline_stages

    data = np.load(sys.argv[1])
    w, xs = jnp.asarray(data["w"]), jnp.asarray(data["xs"])
    S = 4
    out = {"stages": np.asarray(pipeline_stages({"w": w}, S)["w"])}
    for kind in ("tanh", "negzero"):
        def stage_fn(wstage, x):
            def body(x, wi):
                y = x @ wi
                return (jnp.tanh(y) if kind == "tanh"
                        else -jnp.abs(y) * 0.0), None
            return jax.lax.scan(body, x, wstage)[0]
        mesh = make_mesh((S,), ("stage",))
        out[kind] = np.asarray(jax.jit(shard_map(
            lambda ws, v: gpipe_forward(stage_fn, ws, v), mesh=mesh,
            in_specs=(P("stage"), P()), out_specs=P(),
            check_vma=False))(pipeline_stages(w, S), xs))
    np.savez(sys.argv[2], **out)
"""


def _inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, D, D)) * D ** -0.5).astype(np.float32)
    xs = rng.standard_normal((M, B, D)).astype(np.float32)
    return w, xs


def _sequential(w, xs):
    x = torch.from_numpy(xs.reshape(M * B, D))
    for wi in torch.from_numpy(w):
        x = torch.tanh(x @ wi)
    return x.reshape(M, B, D).numpy()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's outputs (a JAX subprocess) and the port's on a
    world of four ranks, computed side by side."""
    tmp = tmp_path_factory.mktemp("gpipe")
    w, xs = _inputs()
    np.savez(tmp / "in.npz", w=w, xs=xs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={S}"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE),
         str(tmp / "in.npz"), str(tmp / "ref.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
    world = World(S, tmp)
    try:
        port = {(kind, n): world.run("gpipe_case", n, w, xs, kind)
                for kind in ("tanh", "negzero") for n in (4, 2)}
    finally:
        world.close()
        try:
            stdout, stderr = proc.communicate(timeout=300)
        finally:
            proc.kill()
    assert proc.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
    return port, dict(np.load(tmp / "ref.npz"))


@pytest.mark.parametrize("stages", [4, 2])
def test_gpipe_matches_sequential(runs, stages):
    port, _ = runs
    outs = [o for o in port["tanh", stages] if o is not None]
    assert len(outs) == stages
    for o in outs[1:]:
        np.testing.assert_array_equal(o.view(np.int32),
                                      outs[0].view(np.int32))
    np.testing.assert_allclose(outs[0], _sequential(*_inputs()), rtol=2e-5,
                               atol=2e-5)


def test_gpipe_matches_reference(runs):
    port, ref = runs
    np.testing.assert_allclose(port["tanh", 4][0], ref["tanh"], rtol=2e-5,
                               atol=2e-5)


def test_negative_zero_as_the_reference_psum(runs):
    port, ref = runs
    assert np.signbit(ref["negzero"]).sum() == 0
    for stages in (4, 2):
        for o in port["negzero", stages]:
            if o is not None:
                np.testing.assert_array_equal(o.view(np.int32),
                                              ref["negzero"].view(np.int32))
    # one stage: no other stage's zero is added
    w, xs = _inputs()
    mesh = make_worker_mesh(1, device="cpu")
    out = gpipe_forward(lambda ws, x: -torch.abs(x @ ws[0]) * 0.0,
                        pipeline_stages(torch.from_numpy(w[:1]), 1),
                        torch.from_numpy(xs), mesh=mesh)
    assert bool(torch.signbit(out).all())


def test_one_stage_matches_sequential():
    w, xs = _inputs()

    def stage_fn(ws, x):
        for wi in ws:
            x = torch.tanh(x @ wi)
        return x

    out = gpipe_forward(stage_fn, pipeline_stages(torch.from_numpy(w), 1),
                        torch.from_numpy(xs),
                        mesh=make_worker_mesh(1, device="cpu"))
    np.testing.assert_allclose(out.numpy(), _sequential(w, xs), rtol=2e-5,
                               atol=2e-5)


def test_pipeline_stages_bit_for_bit(runs):
    _, ref = runs
    w, _ = _inputs()
    got = pipeline_stages({"w": torch.from_numpy(w)}, S)["w"]
    assert tuple(got.shape) == (S, L // S, D, D)
    np.testing.assert_array_equal(got.numpy(), ref["stages"])
    with pytest.raises(AssertionError):
        pipeline_stages(torch.from_numpy(w), 3)
