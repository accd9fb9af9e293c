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
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.common import Sharder
from repro_torch.train.optim import (OptConfig, adamw_init, adamw_update,
                                     leaves)

__all__ = ["init_state", "make_train_step", "make_eval_step",
           "loss_and_grads"]


def init_state(params, opt_cfg: OptConfig) -> dict:
    first = leaves(params)
    dev = first[0].device if first else torch.device("cpu")
    return {"params": params, "opt": adamw_init(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _split_micro(batch, k: int):
    """(B, ...) -> (k, B//k, ...) for every leaf of the batch (views)."""
    def f(x):
        b = x.shape[0]
        assert b % k == 0, (b, k)
        return x.reshape(k, b // k, *x.shape[1:])
    return T.tree_map(f, batch)


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


def loss_and_grads(params, cfg, batch):
    """``(loss, metrics, grads)`` of ``T.loss_fn`` at ``params``: the
    reference's ``value_and_grad``.  ``grads`` has the parameters'
    structure, None where the loss does not reach a parameter; metrics
    are detached 0-d tensors."""
    live = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss, metrics = T.loss_fn(_with_leaves(params, live), cfg, batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return (loss.detach(),
            {key: val.detach() for key, val in metrics.items()},
            _with_leaves(params, grads))


def make_train_step(cfg, opt_cfg: OptConfig, *, rules=None,
                    shard_activations: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``, which
    writes ``state`` in place.  ``shard_activations=True`` needs the
    sharding layer, ROADMAP item 14c: ``NotImplementedError``."""
    Sharder(rules, enabled=shard_activations)
    k = max(cfg.microbatches, 1)

    def train_step(state, batch):
        params = state["params"]
        micro = _split_micro(batch, k)
        gacc = [torch.zeros_like(p) for p in leaves(params)]
        ms = []
        for i in range(k):
            _, metrics, grads = loss_and_grads(
                params, cfg, T.tree_map(lambda x: x[i], micro))
            for acc, g in zip(gacc, leaves(grads)):
                if g is not None:
                    acc.add_(g)
            del grads
            ms.append(metrics)
        for g in gacc:
            g.div_(k)
        new_params, new_opt, om = adamw_update(
            _with_leaves(params, gacc), state["opt"], params, opt_cfg)
        metrics = {key: torch.stack([m[key] for m in ms]).mean()
                   for key in ms[0]}
        metrics.update(om)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, metrics

    return train_step


def make_eval_step(cfg, *, rules=None, shard_activations: bool = False):
    Sharder(rules, enabled=shard_activations)

    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = T.loss_fn(params, cfg, batch)
        return metrics

    return eval_step
