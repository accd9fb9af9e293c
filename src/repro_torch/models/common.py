"""Functional module substrate: declarative parameter plans and shared
layers.

Counterpart of ``repro.models.common``.  A *plan* is a nest of dicts of
`PSpec` leaves describing every parameter: shape, logical axes,
initializer.  From one plan, `init_params` makes the parameters, in the
reference's tree: the same nested dict keys, the same leading layer
axis on stacked blocks.  So a checkpoint written by either package's
``checkpoint.manager`` restores into the other's tree.

``abstract_params`` and ``plan_pspecs`` (the dry run's sharded stand-ins)
and an enabled `Sharder` belong to the sharding layer, ROADMAP item
14c; the port's `Sharder` is the identity when disabled and raises when
asked to shard.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Any

import torch

from repro_torch.kernels.backend import resolve_device

__all__ = ["PSpec", "init_params", "stack_plan", "plan_leaves", "Sharder",
           "DEFAULT_RULES", "rmsnorm", "RMSNORM_EPS", "dense", "Dtypes",
           "cross_entropy"]


@dataclasses.dataclass(frozen=True)
class PSpec:
    """Declarative parameter leaf."""
    shape: tuple
    axes: tuple            # logical axis name (or None) per dim
    init: str = "normal"   # normal | zeros | ones | scaled(fan-in)
    dtype: Any = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


# Default logical->mesh axis rules (production mesh axes: pod/data/model),
# the reference's table; read by configs.arch_rules.
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "attn_seq": None,
    "kv_seq": None,
    "embed": None,
    "act_embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "expert_mlp": None,
    "expert_embed": None,
    "layer": None,
    "state": None,
    "conv": None,
}


def plan_leaves(plan, path=()):
    """``[(path, PSpec)]`` in JAX's flatten order: dict keys sorted."""
    if isinstance(plan, PSpec):
        return [(path, plan)]
    out = []
    for k in sorted(plan):
        out.extend(plan_leaves(plan[k], path + (k,)))
    return out


def _map_plan(plan, fn, path=()):
    if isinstance(plan, PSpec):
        return fn(path, plan)
    return {k: _map_plan(v, fn, path + (k,)) for k, v in plan.items()}


def init_params(plan, *, seed: int = 0,
                generator: torch.Generator | None = None, device=None,
                dtype=None):
    """Materialize parameters on ``device`` (the card unless ``"cpu"``).

    Each leaf draws from its own ``torch.Generator`` on the device,
    seeded by the CRC-32 of ``seed`` (or ``generator.initial_seed()``)
    and the leaf's path, written as the reference writes it
    (``0:['blocks']/['attn']/['wq']``): stable from process to process.
    The reference folds Python's ``hash`` of that path into its key,
    which is salted per process, so its own initialisation changes from
    run to run; parity tests therefore feed both packages the same
    arrays.  The card's and the CPU's generators differ, so the same
    seed gives other values on the card than on the CPU."""
    dev = resolve_device(device)
    base = generator.initial_seed() if generator is not None else seed

    def leaf(path, spec: PSpec):
        dt = dtype or spec.dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        if spec.init == "normal":
            std = 0.02
        elif spec.init == "scaled":   # fan-in scaling on the 2nd-to-last dim
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = fan_in ** -0.5
        else:
            raise ValueError(spec.init)
        pathstr = "/".join(f"['{k}']" for k in path)
        # 32 bits: the CPU generator keeps no more of a seed
        g = torch.Generator(device=dev).manual_seed(
            zlib.crc32(f"{base}:{pathstr}".encode()))
        a = torch.randn(spec.shape, generator=g, dtype=torch.float32,
                        device=dev).mul_(std)
        return a if a.dtype == dt else a.to(dt)

    return _map_plan(plan, leaf)


def stack_plan(plan, n: int, axis_name: str = "layer"):
    """Prefix every leaf with a stacked layer dimension."""
    return _map_plan(plan, lambda _, s: PSpec(
        (n,) + s.shape, (axis_name,) + s.axes, s.init, s.dtype))


class Sharder:
    """Activation-sharding helper.  Disabled, it is the identity, as the
    reference's is on one device; sharding activations over a mesh is
    ROADMAP item 14c, so an enabled one raises."""

    def __init__(self, rules=None, enabled: bool = True):
        if enabled:
            raise NotImplementedError(
                "an enabled Sharder shards activations over a device mesh: "
                "the sharding layer is ROADMAP item 14c, not ported yet")
        self.rules = rules or DEFAULT_RULES
        self.enabled = False

    def __call__(self, x, *axes):
        return x


@dataclasses.dataclass(frozen=True)
class Dtypes:
    param: Any = torch.float32
    compute: Any = torch.bfloat16
    norm: Any = torch.float32  # norms & softmax/loss stay f32


RMSNORM_EPS = 1e-6


def rmsnorm(x, scale, eps: float = RMSNORM_EPS):
    """RMSNorm in f32 whatever the input dtype; multiplies by
    ``1 + scale`` (the scale starts at zero)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def dense(x, w, compute_dtype=torch.bfloat16):
    """x @ w in the compute dtype."""
    return torch.matmul(x.to(compute_dtype), w.to(compute_dtype))


def cross_entropy(logits, labels, mask=None):
    """Token-level cross entropy in f32; labels (B, S) integer, logits
    (B, S, V).  The label's logit is gathered (the reference contracts a
    one-hot, which gives the same value)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
