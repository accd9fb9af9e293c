"""Request-oriented serving API: `SkylineRequest` + `StreamOptions`.

Counterpart of ``repro.serve.api``.  Two validated, frozen config
objects:

  ``SkylineRequest``  ONE skyline query: its data, an optional user
                      mask, an optional preference-scale or subspace
                      *view* of the data, an optional seed for the
                      random strategy, an optional latency deadline and
                      an optional kernel-backend override.
                      `SkylineEngine.submit` / ``submit_many`` answer
                      any mix of requests in bucketed single-launch
                      waves.
  ``StreamOptions``   every `open_stream` knob, keyword-only, checked at
                      construction.

Where the reference takes a ``jax.random`` key, the port takes an int
seed (or None): torch cannot reproduce threefry bits, and a seed only
chooses the random strategy's partition ids, never the answer
(ROADMAP.md, contract 5).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_spec

__all__ = ["SkylineRequest", "StreamOptions", "PIPELINE_DTYPES",
           "check_impl_name"]

# point dtypes the pipeline takes (the sentinel 1.7e38 must be finite,
# and both kernels and the plain versions compare f32)
PIPELINE_DTYPES = (torch.float32,)


def check_impl_name(impl: str) -> None:
    """Raise ``ValueError`` unless ``impl`` names a registered backend
    (or 'auto').  Which device a backend may run on is checked when the
    request is dispatched, where the data lies."""
    resolve_spec(impl, torch.device("cuda"))


def _check_seed(seed, what: str) -> None:
    if seed is not None and (isinstance(seed, bool)
                             or not isinstance(seed, (int, np.integer))):
        raise ValueError(f"{what} must be an int seed or None, got "
                         f"{type(seed).__name__} (the port takes seeds, "
                         f"not jax.random keys)")


@dataclasses.dataclass(frozen=True, eq=False)
class SkylineRequest:
    """One skyline query for `SkylineEngine.submit` / ``submit_many``.

    ``data`` is an (N, d) tensor (on any device) or array.  At most one
    of the two *view* fields may be set: ``scale`` is a ``(d,)`` vector
    of positive per-attribute preference scales (the query answers the
    skyline of ``data * scale``), ``subspace`` is a ``(d,)`` bool mask
    selecting the attributes that discriminate.  Requests sharing the
    same ``data`` object and view kind are stacked into one broadcast
    launch; plain requests group by (d, dtype, N-bucket).

    ``key`` is an int seed for the random strategy's draw, or None for
    the engine's positional default.  ``deadline`` is an absolute
    `time.monotonic()` instant, ignored by the synchronous ``submit``
    path.  ``impl`` overrides the engine's kernel backend for this
    request only; its name is checked here, its device at dispatch."""

    data: Any
    mask: Any | None = None
    scale: Any | None = None
    subspace: Any | None = None
    key: int | None = None
    deadline: float | None = None
    impl: str | None = None

    def __post_init__(self):
        if getattr(self.data, "ndim", None) != 2:
            raise ValueError("request data must be a (N, d) array")
        if self.scale is not None and self.subspace is not None:
            raise ValueError("scale and subspace are mutually exclusive "
                             "views of the data")
        d = self.data.shape[1]
        for name in ("scale", "subspace"):
            v = getattr(self, name)
            if v is not None and tuple(np.shape(v)) != (d,):
                raise ValueError(f"{name} must be shape ({d},) to match "
                                 f"data with d={d}, got {np.shape(v)}")
        _check_seed(self.key, "request key")
        if self.impl is not None:
            check_impl_name(self.impl)  # unknown backends fail fast here

    @property
    def view_kind(self) -> str | None:
        """"scale" / "subspace" for view requests, None for plain."""
        if self.scale is not None:
            return "scale"
        if self.subspace is not None:
            return "subspace"
        return None


@dataclasses.dataclass(frozen=True, eq=False)
class StreamOptions:
    """Every `open_stream` knob, validated at construction.

    ``q`` live skylines share the stream's slab slots and launch waves;
    ``window_epochs=E`` makes them sliding windows over an E-slot epoch
    ring, and ``epoch_capacity`` bounds each epoch's retained-candidate
    buffer (see `repro_torch.core.windowed.epoch_rows`).  ``key`` is an
    int seed for the partitioning of fed chunks (it never changes
    results, only the random strategy's partition assignment).
    ``dtype`` is a torch dtype the pipeline takes (`PIPELINE_DTYPES`)."""

    q: int = 1
    dtype: Any = torch.float32
    key: int | None = None
    window_epochs: int | None = None
    epoch_capacity: int = 0

    def __post_init__(self):
        if self.q < 1:
            raise ValueError(f"need at least one stream, got q={self.q}")
        if self.dtype not in PIPELINE_DTYPES:
            raise ValueError(f"dtype {self.dtype} is not one the port's "
                             f"pipeline takes: {PIPELINE_DTYPES}")
        _check_seed(self.key, "stream key")
        if self.window_epochs is not None and self.window_epochs < 1:
            raise ValueError(f"window_epochs must be >= 1, got "
                             f"{self.window_epochs}")
        if self.epoch_capacity and self.window_epochs is None:
            raise ValueError("epoch_capacity needs a windowed stream "
                             "(StreamOptions(window_epochs=E)); an "
                             "unbounded stream's slots are bounded by "
                             "the state capacity already")
        if self.epoch_capacity < 0:
            raise ValueError(f"epoch_capacity must be >= 0, got "
                             f"{self.epoch_capacity}")
