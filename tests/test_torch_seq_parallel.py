"""The sequence-parallel residual stream of the port's sharded language
models, and the sharded gradients of every model family, on a 2 x 2
(data x model) gloo world.

When a model's heads do not divide the model axis, ``arch_rules`` shards
the sequence instead (``heads=None``, ``head_dim=attn_seq=seq="model"``:
Megatron-SP, each block an all-gather of ``x`` in and a reduce-scatter
of its output's partial sums out).  The case is qwen3-14b's smoke config
with three query heads and one KV head (head_dim 16), so that the rules
of a model axis of two are the sequence-parallel ones.

What is held how:

| What | How it is held |
| --- | --- |
| The rules of the case | exactly: ``heads`` None, ``head_dim``, ``attn_seq`` and ``seq`` over ``model`` |
| Its sharded train step against the one-rank step (``tests/test_distributed.py:84-126``'s tolerances) | bf16: loss 2e-3, parameters rtol 2e-2 and atol 2e-3; f32: 1e-4 |
| Its sharded f32 loss and gradients against the one-rank ones | loss 1e-4; each gradient leaf within 1e-4 of its largest element |
| Its f32 train step with a microbatch of one row over the two data ranks (uneven shards, as llama4-maverick's microbatch of 8 rows over 16 data ranks in the dry run) | loss and parameters 1e-4 |
| Its prefill under the ``prefill_32k`` rules (``kv_seq`` over ``model``), f32 | the last logits and every cache leaf at rtol = atol = 1e-4; the caches' sequence sharded |
| A rotated sliding-window cache's prefill (mixtral's smoke window), f32 | the same |
| Its one-rank f32 forward, prefill and decode against the JAX package | 1e-4, as ``tests/test_torch_transformer.py`` holds them |
| The sharded f32 gradients of one config of each family no other sharded test runs (MoE, SSM, hybrid, VLM, encoder) | each leaf within 1e-4 of its largest element, with q and k at the fan-in d_model as step S1's f32 check on the card has them; the MoE configs at a capacity that drops no token, since a token shard's capacity drops other tokens than one device's does (``models/moe.py``) |

Why q and k at fan-in: with the reference's init the attention is nearly
an argmax, and the one-rank f32 gradients are more sensitive than a
1e-4 bound allows.  A relative perturbation of 1e-7 of the parameters
moves llama4-maverick's smoke gradients by 5.44e-4 of a leaf's largest
element (zamba2 1.99e-3, paligemma 4.79e-4), and its sharded gradients
lie 1.61e-4 of it from the one-rank ones; with q and k at fan-in the
same perturbation moves them by 1.26e-6 (zamba2 1.17e-4, paligemma
1.23e-6), and the sharded ones lie 8.36e-7 off
(``tests/_lm_bf16_probe.py conditioning``, CPU).

One world of four ranks serves the module.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import gc

import jax
import numpy as np
import pytest

from _torch_models import (F32_TOL, assert_caches, assert_close, configs,
                           inputs_pair, params_pair, port_run,
                           reference_run)
from _torch_world import World
from repro_torch.configs import arch_rules, get_config

CASE = ("qwen3-14b", {"n_heads": 3, "n_kv_heads": 1})
F32 = {"compute_dtype": "float32"}
FAMILIES = ("mixtral-8x7b", "llama4-maverick-400b-a17b", "mamba2-780m",
            "zamba2-1.2b", "paligemma-3b", "hubert-xlarge")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(4, tmp_path_factory.mktemp("seq_parallel"))
    yield w
    w.close()


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    yield
    jax.clear_caches()
    gc.collect()


def _assert_grads(grads):
    for k, (one, two) in grads.items():
        bound = 1e-4 * float(np.abs(one).max())
        assert float(np.abs(two - one).max()) <= bound, k


def test_case_rules_are_sequence_parallel():
    arch, kw = CASE
    import dataclasses
    cfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    assert cfg.head_dim_eff == 16
    for shape in ("train_4k", "prefill_32k"):
        rules = arch_rules(cfg, shape, model_axis=2, data_axis=2)
        assert rules["heads"] is None
        assert rules["head_dim"] == rules["attn_seq"] == rules["seq"] \
            == "model", shape
    assert arch_rules(cfg, "prefill_32k", model_axis=2,
                      data_axis=2)["kv_seq"] == "model"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_seq_parallel_train_step_matches_one_rank(world, dtype):
    arch, kw = CASE
    kw = kw if dtype == "bfloat16" else {**kw, **F32}
    loss1, loss2, p1, p2, placed = world.run(
        "sharded_train_step", arch, 2, 2, kw, deadline=240)[0]
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
    # the attention weights are sharded on their head_dim (stacked:
    # (layer, embed, heads, head_dim)), the MLP's on its hidden dim
    assert "Shard(dim=3)" in placed["/blocks/attn/wq"]
    assert "Shard(dim=2)" in placed["/blocks/mlp/wi"]


def test_uneven_microbatches_match_one_rank(world):
    """Eight microbatches of one row on a 2 x 2 mesh: rank (1, *) holds
    no row of a microbatch.  `launch.mesh.local_map` gives each body's
    output its true global shape, where torch's takes the local size
    times the mesh's."""
    arch, kw = CASE
    loss1, loss2, p1, p2, _ = world.run(
        "sharded_train_step", arch, 2, 2, {**kw, **F32, "microbatches": 8},
        deadline=240)[0]
    assert abs(loss1 - loss2) < 1e-4, (loss1, loss2)
    for k in p1:
        np.testing.assert_allclose(p2[k], p1[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_seq_parallel_gradients_match_one_rank(world):
    arch, kw = CASE
    loss1, loss2, grads = world.run("sharded_gradients", arch, 2, 2,
                                    {**kw, **F32}, deadline=240)[0]
    assert abs(loss1 - loss2) < 1e-4, (loss1, loss2)
    _assert_grads(grads)


def test_seq_parallel_prefill_matches_one_rank(world):
    arch, kw = CASE
    rules, last1, last2, caches = world.run(
        "sharded_prefill", arch, 2, 2, {**kw, **F32}, deadline=240)[0]
    assert rules["kv_seq"] == rules["seq"] == "model"
    np.testing.assert_allclose(last2, last1, rtol=1e-4, atol=1e-4)
    assert caches
    for k, (one, two, placed) in caches.items():
        np.testing.assert_allclose(two, one, rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    # (layer, batch, seq, kv_heads, head_dim): the sequence over model
    assert "Shard(dim=2)" in caches["/kv/k"][2]


def test_rolling_cache_prefill_matches_one_rank(world):
    """A sliding-window prefill whose ring is rotated (mixtral's smoke
    window of 16 over 40 prompt tokens: the cache's first slot holds
    position 32), with the cache's sequence over the model axis: the
    rotation runs on each rank with that dim gathered (torch 2.11's
    DTensor has no strategy for ``roll``)."""
    rules, last1, last2, caches = world.run(
        "sharded_prefill", "mixtral-8x7b", 2, 2,
        {**F32, "capacity_factor": 4.0}, 4, 40, deadline=240)[0]
    assert rules["kv_seq"] == "model"
    np.testing.assert_allclose(last2, last1, rtol=1e-4, atol=1e-4)
    for k, (one, two, _) in caches.items():
        np.testing.assert_allclose(two, one, rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    assert caches["/kv/kpos"][0][0, 0] == 32


def test_seq_parallel_case_matches_reference():
    """The case's one-rank f32 forward, prefill and decode against the
    JAX package (``tests/test_torch_transformer.py``'s check)."""
    arch, kw = CASE
    cfg, jcfg = configs(arch, **kw, **F32)
    params, jparams = params_pair(cfg, seed=1)
    tin, jin, tok, pos = inputs_pair(cfg, 2, 20, seed=2)
    want = jax.jit(lambda p, i: reference_run(jcfg, p, i, tok, pos))(
        jparams, jin)
    got = port_run(cfg, params, tin, tok, pos)
    assert_close(got["logits"], want["logits"], F32_TOL, "forward")
    assert_close(got["last"], want["last"], F32_TOL, "prefill")
    assert_caches(got["caches"], want["caches"], F32_TOL, "prefill")
    assert_close(got["dec"], want["dec"], F32_TOL, "decode")


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_gradients_per_family(world, arch):
    kw = dict(F32)
    cfg = get_config(arch, smoke=True)
    if cfg.n_experts:
        # capacity for every token: no drops on one rank or per shard
        kw["capacity_factor"] = float(cfg.n_experts)
    loss1, loss2, grads = world.run("sharded_gradients", arch, 2, 2, kw,
                                    True, deadline=240)[0]
    assert abs(loss1 - loss2) < 1e-4, (loss1, loss2)
    _assert_grads(grads)
