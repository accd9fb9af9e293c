"""Synthetic dataset generators (Börzsönyi et al. conventions, paper §5)
and the paper's real datasets with their surrogate.

Counterpart of ``repro.core.datagen``.  The generators draw from an
explicit ``torch.Generator``; the points are made on the generator's
device, so a CUDA generator makes them on the card.  The draws do not
match ``jax.random``'s: tests that compare the port with the reference
make their inputs with numpy and hand the same arrays to both.
``load_real`` is numpy, a copy of the reference's, so its bits match.

All generators emit points in [0, 1]^d where smaller is better.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device

__all__ = ["generate", "uniform", "correlated", "anticorrelated",
           "load_real", "REAL_SHAPES", "DISTRIBUTIONS"]


def _reflect(x: torch.Tensor) -> torch.Tensor:
    """Reflect out-of-range values back inside [0, 1] (plain clipping
    would pile points up on the boundary)."""
    x = x.abs()
    x = 1.0 - (1.0 - x).abs()
    return x.clamp(0.0, 1.0)


def uniform(gen: torch.Generator, n: int, d: int) -> torch.Tensor:
    """Independent U[0,1] per attribute."""
    return torch.rand((n, d), generator=gen, device=gen.device)


def correlated(gen: torch.Generator, n: int, d: int,
               spread: float = 0.15) -> torch.Tensor:
    """Points clustered around the main diagonal: a common base value per
    tuple plus small independent jitter."""
    base = torch.rand((n, 1), generator=gen, device=gen.device)
    jit = torch.randn((n, d), generator=gen, device=gen.device) * spread
    return _reflect(base + jit)


def anticorrelated(gen: torch.Generator, n: int, d: int) -> torch.Tensor:
    """Points near the anti-diagonal hyperplane sum(x) ~ d/2: good in one
    attribute means bad in others, the hardest case for skylines.  The
    per-tuple plane offset is tight (std 0.05), as in the Börzsönyi
    generator."""
    base = 0.5 + 0.05 * torch.randn((n, 1), generator=gen, device=gen.device)
    jit = torch.rand((n, d), generator=gen, device=gen.device) - 0.5
    # zero-sum jitter spreads each tuple along its hyperplane
    jit = (jit - jit.mean(dim=-1, keepdim=True)) * 0.9
    return _reflect(base + jit)


DISTRIBUTIONS = {
    "uniform": uniform,
    "correlated": correlated,
    "anticorrelated": anticorrelated,
}


def generate(dist: str, gen: torch.Generator, n: int, d: int) -> torch.Tensor:
    try:
        fn = DISTRIBUTIONS[dist]
    except KeyError:
        raise ValueError(f"unknown distribution {dist!r}; one of "
                         f"{list(DISTRIBUTIONS)}") from None
    return fn(gen, n, d)


# ---------------------------------------------------------------------------
# Real datasets (paper §5: HOU, household electricity, 2,049,280 x 7; RES,
# Zillow housing, 3,569,678 x 7).  The raw files are not shipped: a CSV at
# $REPRO_DATA_DIR/<name>.csv is loaded when present, otherwise a surrogate
# with similar gross statistics (heavy skew, mixed correlation across
# attribute pairs) is made.
# ---------------------------------------------------------------------------

REAL_SHAPES = {"hou": (2_049_280, 7), "res": (3_569_678, 7)}

# where a CSV is looked for when $REPRO_DATA_DIR is not set: data/ at the
# root of the checkout
_DEFAULT_DATA_DIR = Path(__file__).resolve().parents[3] / "data"


def _surrogate(name: str, n: int, d: int) -> np.ndarray:
    """The reference's surrogate, bit for bit.  Its seed is
    ``abs(hash(name)) % 2**31``, and Python salts string hashes per
    process, so the draws agree with the reference's only within one
    process."""
    rng = np.random.default_rng(abs(hash(name)) % (2 ** 31))
    # a mixture of correlated groups with log-normal marginals (skew like
    # a utility meter's), min-max normalised to [0, 1]
    g = rng.integers(0, 3, size=d)
    latent = rng.lognormal(mean=0.0, sigma=0.6, size=(n, 3))
    noise = rng.lognormal(mean=0.0, sigma=0.4, size=(n, d))
    x = latent[:, g] * noise
    x = (x - x.min(0)) / (x.max(0) - x.min(0) + 1e-9)
    return x.astype(np.float32)


def load_real(name: str, n: int | None = None, d: int = 7, *,
              device=None) -> torch.Tensor:
    """HOU or RES from ``$REPRO_DATA_DIR/<name>.csv`` if it exists (the
    first ``d`` columns, min-max normalised), else the surrogate of
    ``n`` rows (1,000,000 by default, as in the reference; pass
    ``REAL_SHAPES[name][0]`` for the published size); the first ``n``
    rows.  The tensor is made on ``device``, the card unless
    ``device="cpu"``."""
    name = name.lower()
    if name not in REAL_SHAPES:
        raise ValueError(f"unknown real dataset {name!r}; one of "
                         f"{sorted(REAL_SHAPES)}")
    dev = resolve_device(device)
    path = Path(os.environ.get("REPRO_DATA_DIR", _DEFAULT_DATA_DIR),
                f"{name}.csv")
    if path.exists():
        arr = np.loadtxt(path, delimiter=",", dtype=np.float32)
        arr = arr[:, :d]
        arr = (arr - arr.min(0)) / (arr.max(0) - arr.min(0) + 1e-9)
    else:
        arr = _surrogate(name, n or min(REAL_SHAPES[name][0], 1_000_000), d)
    if n is not None:
        arr = arr[:n]
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
