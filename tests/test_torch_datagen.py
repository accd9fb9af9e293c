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
