"""Abstract input and state specs for the dry run: stand-ins that hold
no memory for every model input and the whole train state.

Counterpart of ``repro.launch.specs``.  Where the reference makes
``ShapeDtypeStruct``s carrying ``NamedSharding``s, the port makes empty
tensors on the meta device (or on ``device``: under ``FakeTensorMode``
they are fake), as DTensors with the spec's placements when a mesh is
given, so that each rank's local shard has its own shape.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.launch.mesh import distribute_tensor
from repro_torch.models import transformer as T
from repro_torch.models.common import abstract_params, axes_to_spec, placements
from repro_torch.sharding import zero1_shardings
from repro_torch.train.optim import OptConfig

__all__ = ["input_specs", "state_specs", "cache_specs"]


def _sds(shape, dtype, mesh, spec, device=None):
    t = torch.empty(shape, dtype=dtype, device=torch.device(device or "meta"))
    if mesh is None:
        return t
    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


def input_specs(cfg, shape_name: str, mesh=None, rules=None, *, device=None):
    """Batch stand-ins for a shape cell.  For decode shapes this is the
    (token, pos) pair; the KV caches come from `cache_specs`."""
    rules = rules or {}
    spec = SHAPES[shape_name]
    b, s = spec.global_batch, spec.seq_len
    bspec = (rules.get("batch"),)

    def sds(shape, dtype, sp):
        return _sds(shape, dtype, mesh, sp, device)

    if spec.kind in ("train", "prefill"):
        if cfg.family == "encoder":
            return {"frames": sds((b, s, cfg.frontend_dim), torch.float32,
                                  (rules.get("batch"), None, None)),
                    "labels": sds((b, s), torch.int32, bspec)}
        if cfg.family == "vlm":
            st = s - cfg.prefix_len
            out = {"image_emb": sds((b, cfg.prefix_len, cfg.frontend_dim),
                                    torch.float32,
                                    (rules.get("batch"), None, None)),
                   "tokens": sds((b, st), torch.int32, bspec)}
            if spec.kind == "train":
                out["labels"] = sds((b, st), torch.int32, bspec)
            return out
        out = {"tokens": sds((b, s), torch.int32, bspec)}
        if spec.kind == "train":
            out["labels"] = sds((b, s), torch.int32, bspec)
        return out

    # decode: one new token against a cache of seq_len
    return {"token": sds((b, 1), torch.int32, bspec),
            "pos": sds((), torch.int32, ())}


def cache_specs(cfg, shape_name: str, mesh=None, rules=None, *, device=None):
    rules = rules or {}
    spec = SHAPES[shape_name]

    def factory(shape, dtype, axes):
        return _sds(shape, dtype, mesh, axes_to_spec(axes, rules), device)

    return T.init_caches(cfg, spec.global_batch, spec.seq_len,
                         factory=factory)


def state_specs(cfg, mesh=None, rules=None, opt_cfg: OptConfig | None = None,
                *, device=None):
    """Abstract train state: parameters and AdamW moments (ZeRO-1
    placements)."""
    opt_cfg = opt_cfg or OptConfig()
    plan = T.lm_plan(cfg)
    pdt = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32
    params = abstract_params(plan, mesh, rules, dtype=pdt, device=device)
    mdt = torch.bfloat16 if opt_cfg.moment_dtype == "bfloat16" \
        else torch.float32
    dev = torch.device(device or "meta")

    def moments_of(tree, shard):
        if isinstance(tree, dict):
            return {k: moments_of(tree[k], shard and shard[k]) for k in tree}
        t = torch.empty(tree.shape, dtype=mdt, device=dev)
        if shard is None:
            return t
        return distribute_tensor(t, *shard, src_data_rank=None)

    moments = moments_of(params, zero1_shardings(plan, rules, mesh)
                         if mesh is not None else None)
    opt = {"m": moments, "v": moments,
           "step": _sds((), torch.int32, mesh, (), device)}
    if opt_cfg.compress == "int8":
        opt["err"] = params
    return {"params": params, "opt": opt,
            "step": _sds((), torch.int32, mesh, (), device)}
