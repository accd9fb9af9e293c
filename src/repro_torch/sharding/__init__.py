"""Sharding utilities: ZeRO-1 optimizer-state specs and spec plumbing.

Counterpart of ``repro.sharding``.  Specs are the tuples of
`repro_torch.models.common.plan_pspecs` (the reference's
``PartitionSpec`` entries); a sharding is a ``(mesh, placements)`` pair,
the counterpart of a ``NamedSharding``, which
``distribute_tensor(x, *pair)`` and ``checkpoint.manager.restore(...,
shardings=)`` take.
"""

from __future__ import annotations

from repro_torch.models.common import PSpec, placements, plan_pspecs

__all__ = ["zero1_pspecs", "named_shardings", "zero1_shardings"]


def _used_axes(spec) -> set:
    used = set()
    for e in spec:
        if e is None:
            continue
        used.update(e if isinstance(e, tuple) else (e,))
    return used


def _zip_plan(specs, plan, fn):
    if isinstance(plan, PSpec):
        return fn(specs, plan)
    return {k: _zip_plan(specs[k], plan[k], fn) for k in plan}


def zero1_pspecs(plan, rules, data_size: int, axis: str = "data"):
    """Optimizer-moment specs: the parameters' specs with the ``data``
    axis added on the first unsharded dim it divides (ZeRO-1 state
    sharding).  The sharded step then reduces each gradient onto the
    moments' shards and gathers the fresh parameters, the ZeRO-1
    communication pattern."""
    def extend(spec: tuple, leaf: PSpec) -> tuple:
        if axis in _used_axes(spec):
            return spec
        entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
        for i, s in enumerate(leaf.shape):
            if entries[i] is None and s % data_size == 0 and s >= data_size:
                entries[i] = axis
                return tuple(entries)
        return spec

    return _zip_plan(plan_pspecs(plan, rules), plan, extend)


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def named_shardings(pspecs, mesh):
    """``(mesh, placements)`` for every spec of a nest of dicts."""
    if _is_spec(pspecs):
        return (mesh, placements(pspecs, mesh))
    return {k: named_shardings(v, mesh) for k, v in pspecs.items()}


def zero1_shardings(plan, rules, mesh):
    names = tuple(mesh.mesh_dim_names or ())
    data = mesh.size(names.index("data")) if "data" in names else 1
    return named_shardings(zero1_pspecs(plan, rules, data), mesh)

