"""Carry state between the JAX package and the port.

The skyline system has no weights: its parameters are the pipeline
config and the arrays.  These functions take the reference's config, as
``dataclasses.asdict`` gives it, a skyline buffer's four leaves, a
streaming state's six and a windowed state's eight, as numpy arrays,
across in either direction, bits unchanged.  A state may carry a leading
Q axis.  On a mesh (`repro_torch.launch.mesh`) every rank holds the
whole state, so a converted reference state or window is made on every
rank from the same arrays: it is replicated, as the port's mesh entry
points expect, and needs no conversion of its own.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.incremental import SkylineState
from repro_torch.core.parallel import SkyConfig
from repro_torch.core.sfs import SkyBuffer
from repro_torch.core.windowed import WindowedSkylineState

__all__ = ["config_from_reference", "buffer_from_numpy", "buffer_to_numpy",
           "state_from_numpy", "state_to_numpy", "window_state_from_numpy",
           "window_state_to_numpy"]

# dtype of each leaf of a buffer, of a state and of a windowed state
_BUFFER_DTYPES = (np.float32, bool, np.int32, bool)
_STATE_DTYPES = _BUFFER_DTYPES + (np.int32, np.int32)
_WINDOW_DTYPES = _STATE_DTYPES + (np.int32, np.int32)


def _leaves_to_device(leaves, dtypes, device):
    return [torch.from_numpy(np.array(x, dtype=dt)).to(device)
            for x, dt in zip(leaves, dtypes, strict=True)]


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
    return SkyBuffer(*_leaves_to_device(leaves, _BUFFER_DTYPES, device))


def buffer_to_numpy(buf: SkyBuffer) -> tuple[np.ndarray, ...]:
    """The four leaves of a ``SkyBuffer`` as numpy arrays."""
    return tuple(x.detach().cpu().numpy() for x in buf)


def state_from_numpy(leaves, *, device) -> SkylineState:
    """A ``SkylineState`` on ``device`` from its six leaves (points, mask,
    count, overflow, seen, chunks) as arrays, batched or not."""
    return SkylineState(*_leaves_to_device(leaves, _STATE_DTYPES, device))


def state_to_numpy(state: SkylineState) -> tuple[np.ndarray, ...]:
    """The six leaves of a ``SkylineState`` as numpy arrays."""
    return tuple(x.detach().cpu().numpy() for x in state)


def window_state_from_numpy(leaves, *,
                            device) -> WindowedSkylineState:
    """A ``WindowedSkylineState`` on ``device`` from its eight leaves
    (points, mask, count, overflow, seen, chunks, head, active) as
    arrays, batched or not."""
    return WindowedSkylineState(*_leaves_to_device(leaves, _WINDOW_DTYPES,
                                                   device))


def window_state_to_numpy(state: WindowedSkylineState
                          ) -> tuple[np.ndarray, ...]:
    """The eight leaves of a ``WindowedSkylineState`` as numpy arrays."""
    return tuple(x.detach().cpu().numpy() for x in state)
