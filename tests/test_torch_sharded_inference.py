"""The sharded prefill and decode of every model family, by value, on a
2 x 2 (data x model) gloo world: every smoke config of
``repro_torch.configs.ARCH_NAMES`` under every inference shape that
``skip_reason`` allows it (prefill_32k: all ten, the encoder's whole
forward standing in for its prefill as the reference's dry run lowers
it; decode_32k: the nine with a decode step; long_500k: the four
sub-quadratic ones), in f32, under ``arch_rules(cfg, shape,
model_axis=2, data_axis=2)``.

A decode case prefills a prompt of 20 tokens on one rank into caches of
32 positions, places them as ``launch.specs.cache_specs`` places that
shape's caches, and runs four greedy ``decode_step``s with the sharder
(mixtral's smoke window of 16 is a rotated ring from the first step on;
long_500k's batch of one is not sharded, its caches' sequence over both
mesh axes).  The JAX package runs the same cases sharded on four forced
host devices in one subprocess (``tests/_jax_sharded.py``), from the
same parameters, while the port's world runs.

What is held how:

| What | How it is held |
| --- | --- |
| The sharded prefill (forward for hubert) against the one-rank prefill | the last logits and every cache leaf at rtol = atol = 1e-4 |
| Four sharded decode steps against the one-rank decode | each step's logits and the final caches at rtol = atol = 1e-4 |
| The caches' placements across the decode steps | each leaf's, after every step, exactly those ``cache_specs`` gave (the reference donates the caches: their layout must not drift) |
| The port's greedy tokens against the reference's one-device ones | exactly |
| The port's sharded prefill and decode against the reference's sharded ones | ``_torch_models.F32_TOL``; caches relative to each leaf's largest value, ``kpos`` bit for bit |
| The MoE configs' decode_32k at their own capacity, against the reference's sharded decode only | the same; a token shard's capacity drops other tokens than one device's, by design, but the two packages' sharded dispatches must drop the same ones |

The MoE configs run at ``capacity_factor = n_experts`` elsewhere, which
drops no token.  One world of four ranks serves the module.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses

import numpy as np
import pytest

import _jax_sharded
from _torch_models import F32_TOL
from _torch_world import World, lm_inputs
from repro_torch.configs import ARCH_NAMES, get_config, skip_reason

S, CACHE_LEN, STEPS = 20, 32, 4
SHAPES = ("prefill_32k", "decode_32k", "long_500k")
CASES = [(a, s) for s in SHAPES for a in ARCH_NAMES
         if skip_reason(get_config(a, smoke=True), s) is None]
OWN = [("mixtral-8x7b", "decode_32k"),
       ("llama4-maverick-400b-a17b", "decode_32k")]


def _kw(arch, own=False):
    kw = {"compute_dtype": "float32"}
    n = get_config(arch, smoke=True).n_experts
    if n and not own:
        kw["capacity_factor"] = float(n)   # no token dropped
    return kw


def _case_id(arch, shape, own=False):
    return f"{arch}:{shape}" + (":own" if own else "")


def _host(arch, shape):
    cfg = get_config(arch, smoke=True)
    return lm_inputs(cfg, 1 if shape == "long_500k" else 4, S)


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The JAX package's sharded cases, started before the port's."""
    cases, arrays = [], {}
    for arch, shape, own in [c + (False,) for c in CASES] + \
            [c + (True,) for c in OWN]:
        cid = _case_id(arch, shape, own)
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  **_kw(arch, own))
        arrays.update(_jax_sharded.case_arrays(cid, cfg, _host(arch, shape)))
        kind = "prefill" if shape == "prefill_32k" else "decode"
        cases.append({"id": cid, "arch": arch, "kw": _kw(arch, own),
                      "kind": kind, "shape": shape, "cache_len": CACHE_LEN,
                      "steps": STEPS})
    run = _jax_sharded.Run(cases, arrays,
                           tmp_path_factory.mktemp("jax_sharded"))
    yield run
    run.close()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("sharded_inference"))
    yield w
    w.close()


_PORT: dict = {}


def _port(world, arch, shape, own=False):
    """The world's results for a case, computed once."""
    key = (arch, shape, own)
    if key not in _PORT:
        host = _host(arch, shape)
        if shape == "prefill_32k":
            _PORT[key] = world.run("sharded_prefill", arch, 2, 2,
                                   _kw(arch), len(host), S, host, CACHE_LEN,
                                   deadline=240)[0]
        else:
            _PORT[key] = world.run("sharded_decode", arch, shape,
                                   _kw(arch, own), host, CACHE_LEN, STEPS,
                                   deadline=240)[0]
    return _PORT[key]


def _assert_leaves(got: dict, want: dict, tol, what, scaled=True):
    """Cache leaves: ``kpos`` bit for bit, the rest at rtol = atol =
    ``tol``, the atol relative to the leaf's largest value when
    ``scaled`` (as ``_torch_models.assert_caches`` holds the port's
    caches against the reference's)."""
    assert got.keys() == want.keys(), (what, sorted(got.keys()
                                                    ^ want.keys()))
    for k in got:
        a, b = got[k], want[k]
        assert a.shape == b.shape, (what, k, a.shape, b.shape)
        if k.endswith("/kpos"):
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")
            continue
        scale = max(1.0, float(np.abs(b).max())) if scaled else 1.0
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[_case_id(*c) for c in CASES])
def test_sharded_matches_one_rank(world, arch, shape):
    if shape == "prefill_32k":
        rules, last1, last2, caches = _port(world, arch, shape)
        assert rules["kv_seq"] == "model"
        np.testing.assert_allclose(last2, last1, rtol=1e-4, atol=1e-4)
        assert bool(caches) == (arch != "hubert-xlarge")
        _assert_leaves({k: v[1] for k, v in caches.items()},
                       {k: v[0] for k, v in caches.items()}, 1e-4, arch,
                       scaled=False)
        return
    rules, fed, logits1, logits2, caches, after = _port(world, arch, shape)
    assert logits1.shape[0] == STEPS and fed.shape[0] == STEPS
    np.testing.assert_allclose(logits2, logits1, rtol=1e-4, atol=1e-4)
    _assert_leaves({k: v[1] for k, v in caches.items()},
                   {k: v[0] for k, v in caches.items()}, 1e-4, arch,
                       scaled=False)
    want = {k: v[2] for k, v in caches.items()}
    assert all(p is not None for p in want.values())
    for i, placed in enumerate(after):
        assert placed == want, (i, {k: (placed[k], want[k]) for k in want
                                    if placed[k] != want[k]})
    # (layer, batch, seq, kv_heads, head_dim): the sequence sharded
    assert all("Shard(dim=2)" in want[k] for k in want if k.endswith("/k"))


@pytest.mark.parametrize("arch,shape,own",
                         [c + (False,) for c in CASES]
                         + [c + (True,) for c in OWN],
                         ids=[_case_id(*c) for c in CASES]
                         + [_case_id(*c, True) for c in OWN])
def test_sharded_matches_reference(world, reference, arch, shape, own):
    cid = _case_id(arch, shape, own)
    if shape == "prefill_32k":
        _, _, last2, caches = _port(world, arch, shape)
        np.testing.assert_allclose(last2, reference[f"{cid}/last"],
                                   rtol=F32_TOL, atol=F32_TOL)
    else:
        _, fed, _, logits2, caches, _ = _port(world, arch, shape, own)
        np.testing.assert_array_equal(fed, reference[f"{cid}/tokens"])
        np.testing.assert_allclose(logits2, reference[f"{cid}/logits"],
                                   rtol=F32_TOL, atol=F32_TOL)
        if own and arch.startswith("llama4"):
            # top-1 of four experts, two tokens a shard: a shard's one
            # slot an expert drops a token one device keeps
            logits1 = _port(world, arch, shape, own)[2]
            assert np.abs(logits2 - logits1).max() > 1e-2
    _assert_leaves({k: v[1] for k, v in caches.items()},
                   reference.cache(cid), F32_TOL, cid)
