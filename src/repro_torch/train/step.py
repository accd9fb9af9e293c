"""Train step: microbatched gradient accumulation, remat'd blocks, mixed
precision, AdamW.

Counterpart of ``repro.train.step``.  TrainState = ``{"params", "opt":
{m, v, step[, err]}, "step"}``, the reference's tree, so either
package's ``checkpoint.manager`` reads the other's files.

Where the reference scans k = ``cfg.microbatches`` microbatches, adds
each gradient to a zero tree in order and divides by k, the port loops:
one forward and backward per microbatch (``torch.autograd.grad``; a
parameter the loss does not reach gets no gradient there and counts as
zeros), accumulated in the same order.  Where the reference donates the
state to its jitted step, the port writes it in place: the step returns
the tensors it was given, updated.  Metrics are the reference's keys
(the microbatches' mean of ``ce_loss``, ``loss`` and, for MoE configs,
``moe_aux_loss``; then ``grad_norm`` and ``lr``), 0-d tensors on the
device; nothing in the step reads the device from the host.

Sharded (``shard_activations=True``), the step runs on a ``DeviceMesh``:
the one the state's DTensors lie on, else the current one
(``launch.mesh.set_mesh``).  Every rank passes the same state
and batch.  Plain leaves are placed first (each rank keeps its shard,
no collective): the parameters by ``plan_pspecs``, the moments (and
error buffers) by ``zero1_shardings``, each microbatch by the rules'
``batch`` axes; DTensor leaves stay where they are, and the state is
then written in place as unsharded.  Each gradient is reduced onto its
moment's shards (a reduce-scatter of its ``Partial`` sums), the AdamW
update runs on those shards in ``optim``'s order of operations, and the
fresh parameters are gathered back into their own placements: the
ZeRO-1 pattern.  Metrics come back replicated, as plain tensors.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.launch.mesh import (DTensor, Replicate, current_mesh,
                                     distribute_tensor, implicit_replication)
from repro_torch.models import transformer as T
from repro_torch.models.common import Sharder, map_plan, placements, plan_pspecs
from repro_torch.sharding import zero1_shardings
from repro_torch.train.optim import (OptConfig, adamw_init, adamw_update,
                                     leaves)

__all__ = ["init_state", "make_train_step", "make_eval_step",
           "loss_and_grads", "shard_state", "shard_params"]


def init_state(params, opt_cfg: OptConfig) -> dict:
    first = leaves(params)
    dev = first[0].device if first else torch.device("cpu")
    return {"params": params, "opt": adamw_init(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _split_micro(batch, k: int, sharder=None):
    """(B, ...) -> (k, B//k, ...) for every leaf of the batch (views);
    sharded, each microbatch over the rules' ``batch`` axes (a batch
    given as DTensors is gathered first: DTensor cannot split a sharded
    dim into microbatches, where XLA reshards)."""
    def f(x):
        b = x.shape[0]
        assert b % k == 0, (b, k)
        if k > 1:
            x = _whole(x)
        y = x.reshape(k, b // k, *x.shape[1:])
        if sharder is not None:
            y = sharder.place(y, None, "batch", *([None] * (y.ndim - 2)))
        return y
    return T.tree_map(f, batch)


def _mesh_of(state):
    for x in leaves(state["params"]):
        if isinstance(x, DTensor):
            return x.device_mesh
    mesh = current_mesh()
    if mesh is None:
        raise ValueError("a sharded step needs a mesh: use "
                         "launch.mesh.set_mesh or give DTensor parameters")
    return mesh


def _placed(x, mesh, pl):
    if isinstance(x, DTensor):
        return x
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _place_tree(tree, plan, mesh, placements_at):
    """``tree`` (shaped like ``plan``) with each plain leaf placed on
    ``mesh`` by ``placements_at(path)``; DTensor leaves as they are."""
    return map_plan(plan, lambda path, _: _placed(
        _at(tree, path), mesh, placements_at(path)))


def shard_params(params, cfg, rules, mesh):
    """The parameters placed on ``mesh`` by ``plan_pspecs``."""
    plan = T.lm_plan(cfg)
    pspecs = plan_pspecs(plan, rules)
    return _place_tree(params, plan, mesh,
                       lambda path: placements(_at(pspecs, path), mesh))


def shard_state(state, cfg, rules, mesh) -> dict:
    """The train state with every plain leaf placed on ``mesh`` (see the
    module docstring); DTensor leaves are kept as they are."""
    plan = T.lm_plan(cfg)
    zshard = zero1_shardings(plan, rules, mesh)
    opt = dict(state["opt"])
    for key in ("m", "v", "err"):
        if key in opt:
            opt[key] = _place_tree(opt[key], plan, mesh,
                                   lambda path: _at(zshard, path)[1])
    return {"params": shard_params(state["params"], cfg, rules, mesh),
            "opt": opt, "step": state["step"]}


def _whole(x):
    """A DTensor replicated over its mesh; a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def _plain(x):
    """A DTensor's value, whole on every rank, as a plain tensor."""
    x = _whole(x)
    return x.to_local() if isinstance(x, DTensor) else x


def _with_leaves(tree, new: list):
    """``tree`` with its leaves (in `leaves` order) replaced by ``new``."""
    it = iter(new)

    def walk(t):
        if isinstance(t, dict):
            out = {}
            for key in sorted(t):
                out[key] = walk(t[key])
            return {key: out[key] for key in t}
        return next(it)

    return walk(tree)


def loss_and_grads(params, cfg, batch, *, sharder=None):
    """``(loss, metrics, grads)`` of ``T.loss_fn`` at ``params``: the
    reference's ``value_and_grad``.  ``grads`` has the parameters'
    structure, None where the loss does not reach a parameter; metrics
    are detached 0-d tensors.  Sharded, the loss is made whole on every
    rank before the backward pass, so each gradient is the whole loss's
    (in ``Partial`` or sharded placements)."""
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, metrics = T.loss_fn(_with_leaves(params, live), cfg, batch,
                              sharder=sharder)
    loss = _whole(loss)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return (loss.detach(),
            {key: val.detach() for key, val in metrics.items()},
            _with_leaves(params, grads))


def make_train_step(cfg, opt_cfg: OptConfig, *, rules=None,
                    shard_activations: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``, which
    writes ``state`` in place.  With ``shard_activations`` it runs
    sharded by ``rules`` (see the module docstring)."""
    k = max(cfg.microbatches, 1)

    def train_step(state, batch):
        if not shard_activations:
            return _step(state, batch, None)
        mesh_ = _mesh_of(state)
        state = shard_state(state, cfg, rules, mesh_)
        with implicit_replication():
            new_state, metrics = _step(state, batch,
                                       Sharder(rules, mesh=mesh_))
        return new_state, {key: _plain(v) for key, v in metrics.items()}

    def _step(state, batch, sh):
        params = state["params"]
        micro = _split_micro(batch, k, sh)
        moments = leaves(state["opt"]["m"])
        # sharded, each gradient sums onto its moment's shards
        gacc = [torch.zeros_like(m, dtype=p.dtype) for p, m in
                zip(leaves(params), moments)]
        ms = []
        for i in range(k):
            _, metrics, grads = loss_and_grads(
                params, cfg, T.tree_map(lambda x: x[i], micro), sharder=sh)
            for acc, g in zip(gacc, leaves(grads)):
                if g is not None:
                    if isinstance(g, DTensor):
                        g = g.redistribute(acc.device_mesh, acc.placements)
                    acc.add_(g)
            del grads
            ms.append(metrics)
        for g in gacc:
            g.div_(k)
        # the update runs on the moments' shards of the parameters
        shards = [p.redistribute(m.device_mesh, m.placements)
                  if isinstance(p, DTensor) else p
                  for p, m in zip(leaves(params), moments)]
        _, new_opt, om = adamw_update(
            _with_leaves(params, gacc), state["opt"],
            _with_leaves(params, shards), opt_cfg)
        for p, s in zip(leaves(params), shards):
            if s is not p:      # gather the fresh parameters
                p.copy_(s.redistribute(p.device_mesh, p.placements))
        metrics = {key: torch.stack([m[key] for m in ms]).mean()
                   for key in ms[0]}
        metrics.update(om)
        new_state = {"params": params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, metrics

    return train_step


def make_eval_step(cfg, *, rules=None, shard_activations: bool = False):
    """Returns ``eval_step(params, batch) -> metrics`` (no gradients);
    sharded as `make_train_step`."""
    def eval_step(params, batch):
        sh, ctx = None, contextlib.nullcontext()
        if shard_activations:
            mesh_ = _mesh_of({"params": params})
            params = shard_params(params, cfg, rules, mesh_)
            sh = Sharder(rules, mesh=mesh_)
            batch = T.tree_map(lambda x: sh.place(
                x, "batch", *([None] * (x.ndim - 1))), batch)
            ctx = implicit_replication()
        with torch.no_grad(), ctx:
            _, metrics = T.loss_fn(params, cfg, batch, sharder=sh)
        return {key: _plain(v) for key, v in metrics.items()}

    return eval_step
