"""The language-model half of serving: the port's greedy decode
(`repro_torch.launch.serve.generate`) against ``repro.launch.serve.
generate``, and decode caches crossing between the packages, on the CPU
in f32 compute.

* Teacher forcing: the port's prefill logits and, fed the reference's
  tokens, its logits at every decode step are within rtol = atol = 1e-4
  of the reference's.
* Tokens: the port's ``generate`` gives the reference's ``generate``
  tokens at every step, up to the first step where they differ; there
  the reference's top-1 minus top-2 logit margin must be at most 1e-3
  (a near tie, which either package may break either way; later steps
  then continue from other tokens and are not compared).
* Caches: the reference's prefill caches, converted
  (`repro_torch.convert.caches_from_numpy`, bit for bit), drive the
  port's ``decode_step``, and the port's drive the reference's
  (1e-4), for every family with a decode step.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_models import (B, CACHE_LEN, F32_TOL, S, assert_caches,
                           assert_close, configs, inputs_pair, params_pair,
                           reference_caches)
from repro.configs import ARCH_NAMES
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT

DECODERS = [a for a in ARCH_NAMES if get_config(a).family != "encoder"]
PROMPT, GEN, GEN_CACHE = 12, 8, 20


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends (memory
    mappings; see ``tests/test_torch_scheduler.py``)."""
    yield
    jax.clear_caches()
    gc.collect()


def _margin(logits) -> np.ndarray:
    top = np.sort(np.asarray(logits, np.float32), axis=-1)
    return top[:, -1] - top[:, -2]


@pytest.mark.parametrize("arch", ["yi-6b", "mixtral-8x7b", "zamba2-1.2b"])
def test_generate_matches_reference(arch):
    """yi-6b (dense), mixtral (a rolling window the decode runs past,
    MoE at decode capacity) and zamba2 (SSM states and the shared
    attention's cache)."""
    cfg, jcfg = configs(arch, compute_dtype="float32")
    params, jparams = params_pair(cfg, seed=11)
    prompts = np.random.default_rng(12).integers(
        0, cfg.vocab, (B, PROMPT)).astype(np.int32)

    want = np.asarray(jserve.generate(jparams, jcfg, jnp.asarray(prompts),
                                      GEN, GEN_CACHE))
    got = tserve.generate(params, cfg, torch.from_numpy(prompts), GEN,
                          GEN_CACHE)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, GEN)

    # the reference's loop, keeping its logits; the port teacher-forced
    caches, logits = jax.jit(lambda p, t: JT.prefill(
        p, jcfg, {"tokens": t}, GEN_CACHE))(jparams, jnp.asarray(prompts))
    step = jax.jit(lambda p, c, t, q: JT.decode_step(p, jcfg, c, t, q))
    tcaches, tlogits = TT.prefill(params, cfg,
                                  {"tokens": torch.from_numpy(prompts)},
                                  GEN_CACHE)
    assert_close(tlogits, logits, F32_TOL, "prefill")
    ref_logits = [np.asarray(logits)]
    for i in range(GEN):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        np.testing.assert_array_equal(np.asarray(tok)[:, 0], want[:, i])
        caches, logits = step(jparams, caches, tok, jnp.int32(PROMPT + i))
        tcaches, tlogits = TT.decode_step(
            params, cfg, tcaches, torch.from_numpy(np.array(tok)),
            torch.tensor(PROMPT + i, dtype=torch.int32))
        assert_close(tlogits, logits, F32_TOL, f"decode step {i}")
        ref_logits.append(np.asarray(logits))

    for i in range(GEN):
        differ = got[:, i].numpy() != want[:, i]
        if differ.any():
            assert (_margin(ref_logits[i])[differ] <= 1e-3).all(), (
                f"step {i}: tokens differ where the reference's margin is "
                f"{_margin(ref_logits[i])[differ]}")
            break


@pytest.mark.parametrize("arch", DECODERS)
def test_caches_cross_packages(arch):
    """The reference's prefill caches, converted, drive the port's
    decode step, and the port's drive the reference's (f32)."""
    cfg, jcfg = configs(arch, compute_dtype="float32")
    params, jparams = params_pair(cfg, seed=6)
    tin, jin, tok, pos = inputs_pair(cfg, B, S, seed=7)
    jprefill = jax.jit(lambda p, i: JT.prefill(p, jcfg, i, CACHE_LEN))
    jdecode = jax.jit(lambda p, c, t, q: JT.decode_step(p, jcfg, c, t, q))
    jcaches, _ = jprefill(jparams, jin)
    tcaches, _ = TT.prefill(params, cfg, tin, CACHE_LEN)

    from_ref = convert.caches_from_numpy(jax.tree.map(np.asarray, jcaches),
                                         device="cpu")
    assert_caches(from_ref, jcaches, 0.0, "converted")
    _, got = TT.decode_step(params, cfg, from_ref, torch.from_numpy(tok),
                            pos)
    _, want = jdecode(jparams, jcaches, jnp.asarray(tok), jnp.int32(pos))
    assert_close(got, want, F32_TOL, "reference caches -> port decode")

    to_ref = reference_caches(convert.caches_to_numpy(tcaches))
    assert_caches(tcaches, to_ref, 0.0, "converted")
    _, want = jdecode(jparams, to_ref, jnp.asarray(tok), jnp.int32(pos))
    _, got = TT.decode_step(params, cfg, tcaches, torch.from_numpy(tok), pos)
    assert_close(got, want, F32_TOL, "port caches -> reference decode")


def test_generate_queues_every_step_on_the_device(monkeypatch):
    """``generate`` reads nothing back to the host: each step's position
    is an element of one device tensor, never a Python int."""
    cfg, _ = configs("yi-6b", compute_dtype="float32")
    params, _ = params_pair(cfg)
    seen = []
    orig = TT.decode_step

    def spy(p, c, caches, token, pos, **kw):
        seen.append(pos)
        return orig(p, c, caches, token, pos, **kw)

    monkeypatch.setattr(TT, "decode_step", spy)
    toks = tserve.generate(params, cfg, torch.zeros((2, 5), dtype=torch.int32),
                           3, 8)
    assert tuple(toks.shape) == (2, 3)
    assert all(isinstance(p, torch.Tensor) and p.dtype == torch.int32
               for p in seen)
    assert [int(p) for p in seen] == [5, 6, 7]
