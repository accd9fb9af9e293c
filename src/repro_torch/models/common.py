"""Functional module substrate: declarative parameter plans and shared
layers.

Counterpart of ``repro.models.common``.  A *plan* is a nest of dicts of
`PSpec` leaves describing every parameter: shape, logical axes,
initializer.  From one plan, `init_params` makes the parameters, in the
reference's tree: the same nested dict keys, the same leading layer
axis on stacked blocks.  So a checkpoint written by either package's
``checkpoint.manager`` restores into the other's tree.

Sharding.  Logical axes map to mesh axes through rules (`DEFAULT_RULES`,
``configs.arch_rules``), as in the reference.  `plan_pspecs` gives each
leaf the reference's ``PartitionSpec`` entries as a tuple (a mesh-axis
name, a tuple of them, or None per dim); `placements` turns such a spec
into DTensor placements on a ``DeviceMesh``.  A dim over a tuple of
axes is sharded over each in the order given, major first, as JAX lays
out ``P(("pod", "data"))``; DTensor shards a dim over several mesh dims
in mesh order, so the tuple must follow the mesh's order.
`abstract_params` makes the dry run's stand-ins: tensors that hold no
memory (on the meta device, or fake under ``FakeTensorMode``), as
DTensors with those placements when a mesh is given.  An enabled
`Sharder` is the reference's ``with_sharding_constraint``: it
redistributes a DTensor to the rule's placements.  Where GSPMD infers
the layout of a product of an activation and a weight, the port says
it: `product` runs the plain product on each rank's shards with the
placements written out, so DTensor searches no strategy for it.
"""

from __future__ import annotations

import dataclasses
import functools
import zlib
from typing import Any

import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.mesh import (DTensor, Partial, Replicate, Shard,
                                     current_mesh, distribute_tensor,
                                     local_map)

__all__ = ["PSpec", "init_params", "abstract_params", "plan_pspecs",
           "placements", "axes_to_spec", "map_plan", "stack_plan",
           "plan_leaves", "Sharder", "DEFAULT_RULES", "rmsnorm",
           "RMSNORM_EPS", "dense", "product", "Dtypes", "cross_entropy"]


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


def map_plan(plan, fn, path=()):
    """``fn(path, leaf)`` over a plan's `PSpec` leaves, in its tree."""
    if isinstance(plan, PSpec):
        return fn(path, plan)
    return {k: map_plan(v, fn, path + (k,)) for k, v in plan.items()}



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

    return map_plan(plan, leaf)


def axes_to_spec(axes, rules) -> tuple:
    """The reference's ``P(*(rules.get(a) ...))`` entries, as a tuple."""
    return tuple(rules.get(a) if a is not None else None for a in axes)


def plan_pspecs(plan, rules=None):
    """Each leaf's spec (`axes_to_spec` of its logical axes), in the
    plan's tree."""
    rules = rules or DEFAULT_RULES
    return map_plan(plan, lambda _, s: axes_to_spec(s.axes, rules))


def placements(spec, mesh) -> tuple:
    """DTensor placements on ``mesh`` of a spec (a tuple of mesh-axis
    names, tuples of them, or None, one per tensor dim; shorter than
    the tensor's rank means None for the rest).  An axis the mesh lacks,
    an axis used twice, or a tuple out of the mesh's order is an error,
    as the reference's ``NamedSharding`` makes it one."""
    names = tuple(mesh.mesh_dim_names or ())
    out = [Replicate()] * mesh.ndim
    used = set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        where = []
        for a in axes:
            if a not in names:
                raise ValueError(f"mesh axis {a!r} of spec {spec} is not "
                                 f"in the mesh's axes {names}")
            if a in used:
                raise ValueError(f"mesh axis {a!r} used twice in {spec}")
            used.add(a)
            where.append(names.index(a))
        if where != sorted(where):
            raise ValueError(f"the axes {axes} of spec {spec} are not in "
                             f"the mesh's order {names}")
        for i in where:
            out[i] = Shard(dim)
    return tuple(out)


def abstract_params(plan, mesh=None, rules=None, dtype=None, *,
                    device=None):
    """Stand-ins of the parameters that hold no memory: empty tensors on
    ``device`` (the meta device by default; a device under
    ``FakeTensorMode`` makes fake tensors), as DTensors with each leaf's
    `placements` when ``mesh`` is given (each rank's local shard shape
    then follows the mesh)."""
    rules = rules or DEFAULT_RULES
    dev = torch.device(device or "meta")

    def leaf(_, spec: PSpec):
        t = torch.empty(spec.shape, dtype=dtype or spec.dtype, device=dev)
        if mesh is None:
            return t
        return distribute_tensor(
            t, mesh, placements(axes_to_spec(spec.axes, rules), mesh),
            src_data_rank=None)

    return map_plan(plan, leaf)


def stack_plan(plan, n: int, axis_name: str = "layer"):
    """Prefix every leaf with a stacked layer dimension."""
    return map_plan(plan, lambda _, s: PSpec(
        (n,) + s.shape, (axis_name,) + s.axes, s.init, s.dtype))


class Sharder:
    """Activation-sharding helper: maps logical axes through the rules
    and redistributes a DTensor to their placements (the reference's
    ``with_sharding_constraint``).  Disabled, it is the identity, as the
    reference's is on one device.  Enabled, a plain tensor is an error:
    the sharded paths hand it DTensors (``mesh``, or the current mesh,
    is where `place` puts plain inputs)."""

    def __init__(self, rules=None, enabled: bool = True, mesh=None):
        self.rules = rules or DEFAULT_RULES
        self.enabled = enabled
        self.mesh = mesh

    def spec(self, *axes) -> tuple:
        return axes_to_spec(axes, self.rules)

    def __call__(self, x, *axes):
        if not self.enabled:
            return x
        if not isinstance(x, DTensor):
            raise TypeError("an enabled Sharder constrains DTensors; got a "
                            f"plain {type(x).__name__} of shape "
                            f"{tuple(x.shape)}")
        mesh = x.device_mesh
        return x.redistribute(mesh, placements(self.spec(*axes), mesh))

    def place(self, x, *axes):
        """A plain tensor, the same on every rank, as a DTensor on the
        sharder's mesh (or the current one) with the rule's placements;
        a DTensor is redistributed.  Each rank keeps its own shard: no
        collective runs."""
        if isinstance(x, DTensor):
            return self(x, *axes)
        mesh = self.mesh or current_mesh()
        if mesh is None:
            raise ValueError("an enabled Sharder places tensors on a mesh: "
                             "pass mesh= or use launch.mesh.set_mesh")
        return distribute_tensor(x, mesh, placements(self.spec(*axes), mesh),
                                 src_data_rank=None)


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


# mesh axes over which a weight shards as FSDP does (gathered for a
# product whose activation that axis shards on another dim); on the
# other axes (``model``) weights stay where they are, as tensor
# parallelism keeps them
_FSDP_AXES = ("pod", "data")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def product(eq: str, x, w, fn=None):
    """``fn(x, w)`` (by default ``torch.einsum(eq, x, w)``) of an
    activation ``x`` and a weight ``w``; ``eq`` names their dims as an
    einsum does, and ``fn`` must compute that einsum.

    On plain tensors it is ``fn(x, w)``.  On DTensors it is ``fn`` of
    each rank's shards under ``local_map``, with the layout said outright
    on every mesh dim, so that DTensor searches no strategy for the
    product (a search that does not end on a 3-D mesh, and that torch
    2.11 refuses where ``x``'s sequence is sharded and the product merges
    it with the batch):

    * ``w`` sharded on a dim of its own (``f`` of ``bsd,df->bsf``): ``x``
      whole on that mesh dim (gathered: Megatron-SP's all-gather of a
      sequence-sharded ``x``), the result sharded on ``f``;
    * ``w`` sharded on a contracted dim or a dim both share: ``x`` sharded
      on the same dim (moved there when it is sharded on another), the
      result a partial sum over that mesh dim, or sharded on the shared
      dim;
    * ``w`` whole: ``x`` keeps a shard of a dim of its own (a batch or
      sequence dim), else is made whole.

    On an FSDP axis (``pod``, ``data``) where ``x`` is sharded on a dim
    of its own, a sharded ``w`` is gathered instead when it is the
    smaller of the two (a training step's expert weights; a decode
    step's few tokens are gathered, and the weights stay).  Each input's
    gradient comes back in its placements (a partial sum where the other
    operand's shards met a whole input)."""
    fn = fn or functools.partial(torch.einsum, eq)
    if not isinstance(x, DTensor) and not isinstance(w, DTensor):
        return fn(x, w)
    mesh = (w if isinstance(w, DTensor) else x).device_mesh
    whole = (Replicate(),) * mesh.ndim
    x = x if isinstance(x, DTensor) else DTensor.from_local(
        x, mesh, whole, run_check=False)
    w = w if isinstance(w, DTensor) else DTensor.from_local(
        w, mesh, whole, run_check=False)
    ins, out = eq.replace(" ", "").split("->")
    xs, ws = ins.split(",")
    names = tuple(mesh.mesh_dim_names or ())
    xpl, wpl, opl, gx, gw = [], [], [], [], []
    for i, (xp, wp) in enumerate(zip(x.placements, w.placements)):
        if wp.is_partial():
            raise ValueError(f"a weight in partial sums: {w.placements}")
        lx = xs[xp.dim] if xp.is_shard() else None
        own = lx is not None and lx in out and lx not in ws
        if wp.is_shard() and own and names[i] in _FSDP_AXES \
                and _nbytes(w) <= _nbytes(x):
            wp = Replicate()                  # FSDP: gather the weight
        lw = ws[wp.dim] if wp.is_shard() else None
        wpl.append(wp)
        if lw is None:
            if own:                           # x's own dim stays sharded
                xpl.append(xp), gx.append(xp), gw.append(Partial())
                opl.append(Shard(out.index(lx)))
            else:
                xpl.append(Replicate()), gx.append(Replicate())
                gw.append(Replicate()), opl.append(Replicate())
        elif lw in xs:                        # contracted, or shared
            sx = Shard(xs.index(lw))
            xpl.append(sx), gx.append(sx), gw.append(wp)
            opl.append(Shard(out.index(lw)) if lw in out else Partial())
        else:                                 # w's own dim
            xpl.append(Replicate()), gx.append(Partial()), gw.append(wp)
            opl.append(Shard(out.index(lw)))
    xpl, wpl = tuple(xpl), tuple(wpl)
    if tuple(x.placements) != xpl:
        x = x.redistribute(mesh, xpl)
    if tuple(w.placements) != wpl:
        w = w.redistribute(mesh, wpl)
    return local_map(fn, out_placements=list(opl),      # one output
                     in_placements=(xpl, wpl),
                     in_grad_placements=(tuple(gx), tuple(gw)),
                     device_mesh=mesh, redistribute_inputs=False)(x, w)


def cross_entropy(logits, labels, mask=None):
    """Token-level cross entropy in f32; labels (B, S) integer, logits
    (B, S, V).  The label's logit is gathered on plain tensors.  On
    DTensors (whose ``gather`` takes no vocab-sharded operand) it is the
    reference's one-hot contraction, which gives the same value: a sum
    of one logit and zeros, per vocab shard and then over the shards."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        vocab = torch.arange(logits.shape[-1], device=labels.device)
        onehot = (labels.long()[..., None] == vocab).float()
        ll = torch.sum(logits * onehot, dim=-1)
    else:
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
