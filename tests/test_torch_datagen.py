"""The port's data generators: shape, dtype, device, the [0, 1] range,
the sign of the attributes' correlation, and reproducibility from a
seeded ``torch.Generator``.  The draws are the port's own (they do not
match ``jax.random``), so nothing here is compared with the JAX package;
the correlation bounds are loose statistical checks at n = 20000."""

import numpy as np
import pytest
import torch

from repro_torch.core import datagen

SIGN = {"uniform": 0, "correlated": 1, "anticorrelated": -1}


@pytest.mark.parametrize("dist", sorted(datagen.DISTRIBUTIONS))
def test_generator_shape_range_and_correlation(dist):
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = datagen.generate(dist, gen, 20_000, 4)
    assert x.shape == (20_000, 4) and x.dtype == torch.float32
    assert x.device.type == "cpu"
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    r = np.corrcoef(x.numpy().T)[np.triu_indices(4, 1)]
    if SIGN[dist] == 0:
        assert np.abs(r).max() < 0.05, r
    else:
        assert (SIGN[dist] * r > 0.1).all(), r


def test_same_seed_same_draws():
    a = datagen.anticorrelated(torch.Generator().manual_seed(5), 100, 3)
    b = datagen.anticorrelated(torch.Generator().manual_seed(5), 100, 3)
    assert torch.equal(a, b)


def test_unknown_distribution_raises():
    with pytest.raises(ValueError, match="unknown distribution"):
        datagen.generate("zipf", torch.Generator(), 10, 2)


@pytest.mark.parametrize("name,n", [("hou", 5000), ("RES", 3000),
                                    ("res", None)])
def test_load_real_surrogate_matches_jax(name, n, monkeypatch, tmp_path):
    """The surrogate is seeded by Python's salted string hash, so both
    packages are called in this one process (ROADMAP.md, queue 3); the
    bits must agree."""
    from repro.core import datagen as jdatagen
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path))   # holds no CSV
    want = np.asarray(jdatagen.load_real(name, n))
    got = datagen.load_real(name, n, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert got.shape == (n or 1_000_000, 7)


def test_load_real_reads_a_csv_like_jax(monkeypatch, tmp_path):
    from repro.core import datagen as jdatagen
    rng = np.random.default_rng(0)
    raw = rng.lognormal(size=(50, 9)).astype(np.float32) * 10
    np.savetxt(tmp_path / "hou.csv", raw, delimiter=",")
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path))
    for n, d in ((None, 7), (20, 4)):
        want = np.asarray(jdatagen.load_real("hou", n, d))
        got = datagen.load_real("hou", n, d, device="cpu")
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))
    with pytest.raises(ValueError, match="unknown real dataset"):
        datagen.load_real("zillow", device="cpu")
    assert datagen.REAL_SHAPES == {"hou": (2_049_280, 7),
                                   "res": (3_569_678, 7)}
