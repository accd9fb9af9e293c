"""The port's gradients against the reference's on the CPU, for the
smoke configs with SSM blocks or MoE layers (the attention-only configs
are in ``tests/test_torch_train_step.py``; the tolerances are stated
there and in ``tests/_torch_train.py``).  ``mamba2-780m``'s bf16 case is
the regression test of its SiLU rounding (`repro_torch.models.ssm.silu`):
with ``F.silu`` its ``blocks/ln`` gradient was 4.4x the bound and
``blocks/mamba/dt_bias``'s 5.1x.
MoE routing: the reference's bf16 choices, taken by its f32 run and
replayed in the port."""

import gc

import jax
import pytest

from _torch_train import (check_bf16_gradients, check_f32_gradients,
                          clear_reference_gradients,
                          one_torch_thread)

ARCHS = ["mamba2-780m", "zamba2-1.2b", "mixtral-8x7b",
         "llama4-maverick-400b-a17b"]


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends (memory
    mappings; see ``tests/test_torch_scheduler.py``), and run on one
    torch thread meanwhile."""
    restore = one_torch_thread()
    yield
    restore()
    clear_reference_gradients()
    jax.clear_caches()
    gc.collect()


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_gradients_match_reference(arch, monkeypatch):
    check_f32_gradients(arch, monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_gradients_within_own_error(arch, monkeypatch):
    check_bf16_gradients(arch, monkeypatch)
