"""The port's Pareto-front curation against ``repro.data.selection``.

``pareto_mask``, ``pareto_select`` and ``example_criteria`` are held bit
for bit (floats through their int32 bits, indices exactly) on Hypothesis
draws of tied criteria with both signed zeros and subnormals, and
``pareto_mask`` with the default ``SkyConfig`` as ``distributed_cfg``
(the reference runs the pipeline and answers with the blocked test; so
does the port).  The normalisation's signed-zero order is XLA's (a
column's minimum is ``-0.0`` when it holds both zeros), which the
scheduler's criteria share.  Tolerance: zero.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import parallel as jpar
from repro.data import selection as jsel
from repro.serve import scheduler as jsched
from repro_torch.core.parallel import SkyConfig
from repro_torch.data import selection as tsel
from repro_torch.serve import scheduler as tsched

# tied values, both zeros, subnormals of both signs, normal values
PALETTE = np.float32([0.0, -0.0, 1e-40, -1e-40, 1.4e-45, 0.25, 0.5, 1.0,
                      -1.0, 3.0, -2.5])


@pytest.fixture(autouse=True, scope="module")
def _release_jax_programs():
    """Drop the JAX programs this module compiled once it ends (memory
    mappings; see ``tests/test_torch_scheduler.py``)."""
    yield
    jax.clear_caches()
    gc.collect()


def _bits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_bits(got: torch.Tensor, want) -> None:
    g, w = _bits(got.numpy()), _bits(want)
    assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(g, w)


def _criteria(data, n, d):
    idx = data.draw(st.lists(st.integers(0, len(PALETTE) - 1),
                             min_size=n * d, max_size=n * d))
    return PALETTE[np.asarray(idx)].reshape(n, d)


@settings(max_examples=25, deadline=None, database=None)
@given(st.data(), st.sampled_from([1, 2, 9, 40]), st.integers(1, 4))
def test_pareto_mask_and_select_match_jax(data, n, d):
    crit = _criteria(data, n, d)
    k = data.draw(st.integers(1, n + 2))
    _assert_bits(tsel.pareto_mask(crit, device="cpu"),
                 jsel.pareto_mask(jnp.asarray(crit)))
    order, front = tsel.pareto_select(crit, k, device="cpu")
    jorder, jfront = jsel.pareto_select(jnp.asarray(crit), k)
    _assert_bits(order, jorder)
    _assert_bits(front, jfront)
    _assert_bits(tsel._normalize(torch.from_numpy(crit)),
                 jsel._normalize(jnp.asarray(crit)))


@settings(max_examples=20, deadline=None, database=None)
@given(st.data(), st.sampled_from([1, 3, 17]))
def test_example_criteria_match_jax(data, n):
    loss = _criteria(data, n, 1)[:, 0]
    lengths = np.asarray(data.draw(st.lists(
        st.integers(-3, 2 ** 20), min_size=n, max_size=n)), np.int32)
    recency = np.asarray(data.draw(st.lists(
        st.integers(0, 50), min_size=n, max_size=n)), np.int64)
    got = tsel.example_criteria(loss, lengths, recency, device="cpu")
    want = jsel.example_criteria(jnp.asarray(loss), jnp.asarray(lengths),
                                 jnp.asarray(recency))
    _assert_bits(got, want)


def test_distributed_cfg_answers_as_the_reference():
    rng = np.random.default_rng(3)
    crit = (rng.integers(0, 12, (600, 3)) / 12).astype(np.float32)
    crit[rng.random(crit.shape) < 0.05] = -0.0
    got = tsel.pareto_mask(crit, distributed_cfg=SkyConfig(), device="cpu")
    want = jsel.pareto_mask(jnp.asarray(crit),
                            distributed_cfg=jpar.SkyConfig())
    _assert_bits(got, want)
    _assert_bits(got, jsel.pareto_mask(jnp.asarray(crit)))
    assert 0 < int(got.sum()) < 600


def test_entry_points_run_where_asked(monkeypatch):
    crit = np.float32([[0.0, 1.0], [1.0, 0.0]])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tsel.pareto_mask(crit),
                 lambda: tsel.pareto_select(crit, 1),
                 lambda: tsel.example_criteria(crit[:, 0], crit[:, 1],
                                               crit[:, 1])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert tsel.pareto_mask(crit, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("rows", [
    [[0.0, 1.0, 2.0], [-0.0, 2.0, 3.0], [1.0, -0.0, 0.0]],
    [[-1e-40, 1.0, 2.0], [1e-40, 2.0, 3.0], [0.5, 0.5, -0.0]],
    [[-1.0, -0.0, 5.0], [-2.0, 0.0, 5.0], [-1e-40, -0.0, 5.0]]])
def test_scheduler_criteria_signed_zeros_match_jax(rows):
    """The admission criteria share the normalisation: a column holding
    both zeros takes -0.0 as its minimum and +0.0 as its maximum, as
    XLA's reductions do."""
    rows = np.asarray(rows, np.float32)
    cols = (rows[:, 0], rows[:, 1], rows[:, 2])
    got = tsched._criteria(tsched.Request(*cols), torch.device("cpu"))
    want = jsched._criteria(jsched.Request(*(jnp.asarray(c) for c in cols)))
    _assert_bits(got, want)
