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

The language models (`repro_torch.models`) carry their parameters and
decode caches across the same way: a config from ``dataclasses.asdict``
of the reference's ``ModelConfig``, the parameter tree (nested dicts of
arrays, the reference's keys) and the cache tree (dicts of stacked
`KVCache` and `SSMState`, or of objects with the same fields, such as
the reference's own with numpy leaves).  bfloat16 leaves keep their two
bytes: they come back as ml_dtypes' ``bfloat16`` where that package is
installed, else as numpy's two-byte ``V2``.

Kernel-tuning tables (`repro_torch.kernels.tuning`) and checkpoints
(`repro_torch.checkpoint.manager`) need nothing here: both are files in
the reference's format (the same JSON keys; the same file and leaf
names), which either package reads as they are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.incremental import SkylineState
from repro_torch.core.parallel import SkyConfig
from repro_torch.core.sfs import SkyBuffer
from repro_torch.core.windowed import WindowedSkylineState
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.ssm import SSMState
from repro_torch.models.transformer import tree_map

__all__ = ["config_from_reference", "buffer_from_numpy", "buffer_to_numpy",
           "state_from_numpy", "state_to_numpy", "window_state_from_numpy",
           "window_state_to_numpy", "model_config_from_reference",
           "params_from_numpy", "params_to_numpy", "caches_from_numpy",
           "caches_to_numpy"]

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


def model_config_from_reference(d: dict) -> ModelConfig:
    """The port's ``ModelConfig`` from ``dataclasses.asdict`` of the
    reference's; raises on a field the port does not know."""
    unknown = set(d) - {f.name for f in dataclasses.fields(ModelConfig)}
    if unknown:
        raise ValueError(f"unknown ModelConfig fields: {sorted(unknown)}")
    return ModelConfig(**d)


def _leaf_from_numpy(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.itemsize == 2 and a.dtype.kind == "V" or \
            a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, order="C"))
    return t.to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.view(torch.int16).numpy()
    try:
        import ml_dtypes
    except ImportError:
        return bits.view("V2")
    return bits.view(ml_dtypes.bfloat16)


def params_from_numpy(tree, *, device):
    """A parameter tree (nested dicts of arrays) as tensors on
    ``device``, bits unchanged."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device)
                for k, v in tree.items()}
    return _leaf_from_numpy(tree, device)


def params_to_numpy(tree):
    """A parameter tree's tensors as numpy arrays, bits unchanged."""
    return tree_map(_leaf_to_numpy, tree)


def caches_from_numpy(tree, *, device):
    """A decode-cache tree on ``device``: dicts (and lists) whose leaves
    are KV caches (anything with ``k``, ``v``, ``kpos`` and ``rolling``)
    or SSM states (``h``, ``conv_x``, ``conv_B``, ``conv_C``) of arrays."""
    if isinstance(tree, dict):
        return {k: caches_from_numpy(v, device=device)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [caches_from_numpy(v, device=device) for v in tree]
    if hasattr(tree, "kpos"):
        return KVCache(*(_leaf_from_numpy(x, device)
                         for x in (tree.k, tree.v, tree.kpos)),
                       rolling=bool(tree.rolling))
    if all(hasattr(tree, f) for f in SSMState._fields):
        return SSMState(*(_leaf_from_numpy(getattr(tree, f), device)
                          for f in SSMState._fields))
    raise TypeError(f"not a cache tree node: {type(tree).__name__}")


def caches_to_numpy(tree):
    """A decode-cache tree with numpy leaves, in the port's node types
    (`KVCache`, `SSMState`), bits unchanged."""
    return tree_map(_leaf_to_numpy, tree)
