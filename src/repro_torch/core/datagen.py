"""Synthetic dataset generators (Börzsönyi et al. conventions, paper §5).

Counterpart of the generators of ``repro.core.datagen``, drawn from an
explicit ``torch.Generator``; the points are made on the generator's
device, so a CUDA generator makes them on the card.  The draws do not
match ``jax.random``'s: tests that compare the port with the reference
make their inputs with numpy and hand the same arrays to both.

All generators emit points in [0, 1]^d where smaller is better.
"""

from __future__ import annotations

import torch

__all__ = ["generate", "uniform", "correlated", "anticorrelated",
           "DISTRIBUTIONS"]


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
