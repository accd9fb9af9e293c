"""Carry state between the JAX package and the port.

The skyline system has no weights: its parameters are the pipeline
config and the arrays.  These functions take the reference's config, as
``dataclasses.asdict`` gives it, and a skyline buffer's four leaves, as
numpy arrays, across in either direction, bits unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.parallel import SkyConfig
from repro_torch.core.sfs import SkyBuffer

__all__ = ["config_from_reference", "buffer_from_numpy", "buffer_to_numpy"]


def config_from_reference(d: dict) -> SkyConfig:
    """The port's ``SkyConfig`` from ``dataclasses.asdict`` of the
    reference's; raises on a field the port does not know."""
    unknown = set(d) - {f.name for f in dataclasses.fields(SkyConfig)}
    if unknown:
        raise ValueError(f"unknown SkyConfig fields: {sorted(unknown)}")
    return SkyConfig(**d)


def buffer_from_numpy(leaves, *, device) -> SkyBuffer:
    """A ``SkyBuffer`` on ``device`` from its four leaves (points, mask,
    count, overflow) as arrays."""
    points, mask, count, overflow = (np.asarray(x) for x in leaves)
    return SkyBuffer(
        torch.from_numpy(np.array(points, dtype=np.float32)).to(device),
        torch.from_numpy(np.array(mask, dtype=bool)).to(device),
        torch.from_numpy(np.array(count, dtype=np.int32)).to(device),
        torch.from_numpy(np.array(overflow, dtype=bool)).to(device))


def buffer_to_numpy(buf: SkyBuffer) -> tuple[np.ndarray, ...]:
    """The four leaves of a ``SkyBuffer`` as numpy arrays."""
    return tuple(x.detach().cpu().numpy() for x in buf)
