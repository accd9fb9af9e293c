"""The port's language models (`repro_torch.models.transformer`) against
``repro.models.transformer`` on the CPU, for the ten smoke configs.

Both packages get the same parameters (the port's seeded CPU
``init_params`` as numpy arrays) and the same inputs.  What is held:

* f32 compute, rtol = atol = 1e-4: ``forward``, ``prefill`` (logits and
  every cache leaf; ``kpos`` exactly), ``decode_step`` (logits and the
  new caches) and ``loss_fn`` (loss and metrics), against the reference
  jitted;
* bf16 compute (the configs' default), against the reference compiled
  without excess precision (`_torch_models.op_by_op`: every operation's
  bf16 result rounded, as torch rounds it; the same bits as the
  reference run op by op), forward, prefill and decode logits together,
  norm-wise: |port - reference| at most |reference bf16 - reference f32|
  (`_torch_models.assert_bf16_within_own_error`).  Elementwise 3e-2 /
  4e-2 (``tests/test_models_smoke.py:82-91``) does not hold for every
  input: the reference's own jitted and op-by-op runs differ by up to
  0.2012 on llama4's smoke config and 0.1169 on paligemma's over seeds
  0-5 (``tests/_lm_bf16_probe.py parity``).  The MoE
  configs' case, with the reference's routing replayed in the port, is
  in ``tests/test_torch_moe.py``;
* exactly: the embedding lookup, and a forward from a checkpoint the
  reference wrote (restored by the port's manager into ``lm_plan``'s
  tree) against one from converted parameters;
* the port alone, as ``tests/test_models_smoke.py`` holds the
  reference: forward shapes and finite logits (and a finite loss) on the
  data pipeline's batches, and prefill/decode consistency against the
  full forward in f32 with drop-free capacity (the train-step half is
  training, ROADMAP item 14b).

Decode caches crossing between the packages are held in
``tests/test_torch_serve_lm.py``.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import (B, F32_TOL, S, assert_bits, assert_caches,
                           assert_close, check_bf16_against_reference,
                           configs, inputs_pair, params_pair, port_run,
                           reference_run)
from repro.checkpoint import manager as jman
from repro.configs import ARCH_NAMES
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.checkpoint import manager as tman
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataState, make_batch
from repro_torch.models import transformer as TT
from repro_torch.models.common import init_params

DECODERS = [a for a in ARCH_NAMES if get_config(a).family != "encoder"]


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends (memory
    mappings; see ``tests/test_torch_scheduler.py``)."""
    yield
    jax.clear_caches()
    gc.collect()


def _batches(cfg, seed=3):
    """A training batch from the port's pipeline (bit for bit the
    reference's), with some labels masked."""
    batch = make_batch(cfg, B, S, DataState(seed, 0), device="cpu")
    batch["labels"][:, ::5] = -1
    return batch, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_f32_matches_reference(arch):
    cfg, jcfg = configs(arch, compute_dtype="float32")
    params, jparams = params_pair(cfg, seed=1)
    tin, jin, tok, pos = inputs_pair(cfg, B, S, seed=2)
    batch, jbatch = _batches(cfg)
    want = jax.jit(lambda p, i, b: reference_run(jcfg, p, i, tok, pos, b))(
        jparams, jin, jbatch)
    got = port_run(cfg, params, tin, tok, pos, batch)
    assert_close(got["logits"], want["logits"], F32_TOL, "forward")
    assert set(got["aux"]) == set(want["aux"])
    for k in want["aux"]:
        assert_close(got["aux"][k], want["aux"][k], F32_TOL, k)
    loss, metrics = got["loss"]
    jloss, jmetrics = want["loss"]
    assert_close(loss, jloss, F32_TOL, "loss")
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        assert_close(metrics[k], jmetrics[k], F32_TOL, k)
    if cfg.family == "encoder":
        return
    assert_close(got["last"], want["last"], F32_TOL, "prefill")
    assert_caches(got["caches"], want["caches"], F32_TOL, "prefill")
    assert_close(got["dec"], want["dec"], F32_TOL, "decode")
    assert_caches(got["new_caches"], want["new_caches"], F32_TOL, "decode")


@pytest.mark.parametrize("arch", [a for a in ARCH_NAMES
                                  if not get_config(a).n_experts])
def test_bf16_matches_reference_op_by_op(arch, monkeypatch):
    """bf16 parity (the MoE configs' case is in
    ``tests/test_torch_moe.py``)."""
    check_bf16_against_reference(arch, monkeypatch)


def test_embedding_lookup_is_exact():
    cfg, jcfg = configs("yi-6b")
    params, jparams = params_pair(cfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_padded, (3, 7))
    got = TT._embed_lookup(params["embed"], torch.from_numpy(toks),
                           torch.bfloat16)
    want = JT._embed_lookup(jparams["embed"], jnp.asarray(toks),
                            jnp.bfloat16, None)
    assert_bits(got.view(torch.int16), np.asarray(want).view(np.int16))


@pytest.mark.parametrize("arch", ["yi-6b", "llama4-maverick-400b-a17b"])
def test_checkpoint_from_reference_restores_into_lm_plan(arch, tmp_path):
    """The reference's checkpoint manager saves f32 smoke parameters;
    the port's restores them into ``lm_plan``'s tree; the forward equals
    the one from converted parameters bit for bit."""
    cfg, _ = configs(arch, compute_dtype="float32")
    params, jparams = params_pair(cfg, seed=8)
    jman.save(str(tmp_path), 3, jparams, {"data_step": 3})
    target = init_params(TT.lm_plan(cfg), seed=99, device="cpu")
    restored, step, extra = tman.restore(str(tmp_path), target)
    assert step == 3 and extra["data_step"] == 3
    converted = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    flat_r, flat_c = tman._flatten(restored), tman._flatten(converted)
    assert list(flat_r) == list(flat_c) == list(tman._flatten(params))
    for key in flat_c:
        assert_bits(flat_r[key], flat_c[key].numpy(), key)
    tin, _, _, _ = inputs_pair(cfg, B, S, seed=9)
    got, _, _ = TT.forward(restored, cfg, tin)
    want, _, _ = TT.forward(converted, cfg, tin)
    assert_bits(got, want.numpy())


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_smoke_forward_shapes_and_finite(arch):
    """``tests/test_models_smoke.py``'s forward check on the port: a
    pipeline batch of 4 x 32 gives (4, 32, vocab_padded) finite
    logits."""
    cfg = get_config(arch, smoke=True)
    params = init_params(TT.lm_plan(cfg), seed=0, device="cpu")
    batch = make_batch(cfg, 4, 32, DataState(0, 0), device="cpu")
    logits, _, _ = TT.forward(params, cfg, batch)
    assert logits.shape == (4, 32, cfg.vocab_padded)
    assert bool(torch.isfinite(logits).all())
    loss, metrics = TT.loss_fn(params, cfg, batch)
    assert bool(torch.isfinite(loss)) and "ce_loss" in metrics


@pytest.mark.parametrize("arch", DECODERS)
def test_smoke_prefill_decode_consistency(arch):
    """``tests/test_models_smoke.py``'s consistency check on the port:
    prefill of s tokens and one decode step against the full forward
    over s + 1, in f32 with drop-free capacity."""
    base = get_config(arch, smoke=True)
    cfg = dataclasses.replace(base, remat=False, compute_dtype="float32",
                              capacity_factor=float(max(base.n_experts, 1)))
    params = init_params(TT.lm_plan(cfg), seed=0, device="cpu")
    b, s = 2, 24
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (b, s + 1), generator=g,
                         dtype=torch.int32)
    if cfg.family == "vlm":
        img = torch.randn((b, cfg.prefix_len, cfg.frontend_dim),
                          generator=g)
        full_in = {"image_emb": img, "tokens": toks}
        pre_in = {"image_emb": img, "tokens": toks[:, :s]}
        total = cfg.prefix_len + s + 1
    else:
        full_in = {"tokens": toks}
        pre_in = {"tokens": toks[:, :s]}
        total = s + 1
    logits_full, _, _ = TT.forward(params, cfg, full_in)
    caches, last = TT.prefill(params, cfg, pre_in, 64)
    assert_close(last, logits_full[:, -2], 3e-2)
    _, dec = TT.decode_step(params, cfg, caches, toks[:, s:s + 1],
                            total - 1)
    assert_close(dec, logits_full[:, -1], 4e-2)


def test_encoder_has_no_decode():
    cfg = get_config("hubert-xlarge", smoke=True)
    with pytest.raises(ValueError, match="no decode step"):
        TT.init_caches(cfg, 2, 16, device="cpu")
