"""The port's input pipeline against ``repro.data.pipeline``: the same
batches, bit for bit, for a token family (``dense``, the default
branch), ``encoder`` and ``vlm``, from one small config object given to
both packages, and from each package's own smoke config of the ten
architectures (`repro_torch.configs` against `repro.configs`); cursors
advance alike, and shards and steps differ.  Tolerance: zero."""

import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES
from repro.configs import get_config as jget
from repro.data import pipeline as jpipe
from repro_torch.configs import get_config as tget
from repro_torch.data import pipeline as tpipe


@dataclasses.dataclass(frozen=True)
class Cfg:
    family: str
    vocab: int = 97
    frontend_dim: int = 6
    prefix_len: int = 3


def _assert_batch(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for key in want:
        w = np.asarray(want[key])
        g = got[key]
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


@pytest.mark.parametrize("family", ["dense", "encoder", "vlm"])
@pytest.mark.parametrize("shard_id", [0, 3])
def test_batches_match_jax(family, shard_id):
    cfg = Cfg(family)
    state = tpipe.DataState(seed=11, step=0)
    jstate = jpipe.DataState(seed=11, step=0)
    for _ in range(3):
        got, state = tpipe.next_batch(cfg, 4, 12, state, shard_id,
                                      device="cpu")
        want, jstate = jpipe.next_batch(cfg, 4, 12, jstate, shard_id)
        _assert_batch(got, want)
        assert (state.seed, state.step) == (jstate.seed, jstate.step)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batches_from_the_ports_configs_match_jax(arch):
    state = tpipe.DataState(seed=5, step=2)
    got = tpipe.make_batch(tget(arch, smoke=True), 3, 24, state, 1,
                           device="cpu")
    want = jpipe.make_batch(jget(arch, smoke=True), 3, 24,
                            jpipe.DataState(seed=5, step=2), 1)
    _assert_batch(got, want)


def test_streams_differ_by_shard_and_step():
    cfg = Cfg("dense")
    a = tpipe.make_batch(cfg, 2, 8, tpipe.DataState(0, 0), 0, device="cpu")
    b = tpipe.make_batch(cfg, 2, 8, tpipe.DataState(0, 0), 1, device="cpu")
    c = tpipe.make_batch(cfg, 2, 8, tpipe.DataState(0, 1), 0, device="cpu")
    assert not torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])


def test_make_batch_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpipe.make_batch(Cfg("dense"), 2, 8, tpipe.DataState(0, 0))
