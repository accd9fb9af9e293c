"""AdamW with cosine schedule, global-norm clipping, optional low-precision
moments, and optional int8 gradient compression with error feedback.

Counterpart of ``repro.train.optim``.  The state tree has the reference's
keys: ``m``, ``v`` (in ``moment_dtype``), ``step`` (0-d int32) and, under
``compress="int8"``, ``err``.  Leaves are visited in JAX's order (dict
keys sorted), so the global norm sums them in the reference's order.

The update is written in place (the reference jits its train step with
the state donated): ``adamw_update(..., donate=True)`` writes the
parameters, moments and error buffers it is given and returns them;
``donate=False`` works on copies and leaves its inputs as they were, bit
for bit the same values.  Every elementwise expression keeps the
reference's order of operations, so on the same gradients and the same
scalars the update is the reference's bit for bit; the scalars (the
learning rate's cosine, the bias corrections ``b ** step``) are the
platform's own ``cos`` and ``pow`` and may differ from XLA's in the last
bit.  ``torch.optim.AdamW`` and the fused ``_foreach`` kernels compute
other formulas, so the update is written out here.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.transformer import tree_map

__all__ = ["OptConfig", "adamw_init", "adamw_update", "cosine_lr",
           "clip_by_global_norm", "quantize_int8", "dequantize_int8",
           "leaves"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"    # bfloat16 for llama4-scale
    compress: str | None = None      # None | "int8"


def leaves(tree) -> list:
    """The leaves of a nest of dicts, keys sorted as ``jax.tree.leaves``
    visits them (a missing gradient, None, is a leaf here)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def cosine_lr(step, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup then cosine decay to zero, f32; ``step`` an int or
    an integer tensor (the result lies on its device)."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


def _moment_dtype(cfg: OptConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" \
        else torch.float32


def adamw_init(params, cfg: OptConfig) -> dict:
    """Zero moments (and zero error buffers under int8) shaped like the
    parameters, on their devices, and a 0-d int32 step."""
    mdt = _moment_dtype(cfg)
    first = leaves(params)
    dev = first[0].device if first else torch.device("cpu")
    state = {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                        device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                        device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if cfg.compress == "int8":
        state["err"] = tree_map(torch.zeros_like, params)
    return state


def clip_by_global_norm(grads, max_norm: float, *, donate: bool = False):
    """Scale every gradient by ``min(1, max_norm / norm)``; returns
    ``(grads, norm)``.  The norm sums each leaf's squares in f32, leaf
    by leaf in the reference's order.  ``donate=True`` scales the given
    tensors in place."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    def one(g):
        if donate and g.dtype == torch.float32:
            return g.mul_(scale)
        out = (g.float() * scale).to(g.dtype)
        return g.copy_(out) if donate else out

    return tree_map(one, grads), gnorm


def quantize_int8(g):
    """``(codes, scale)``: symmetric per-tensor int8 quantization, codes
    rounded half to even and clipped to [-127, 127]."""
    gf = g.float()
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale, dtype):
    return (q.float() * scale).to(dtype)


def _compress_(g, e) -> None:
    """Error-feedback int8 round trip of one gradient, in place: ``g``
    becomes the gradient as it crosses the wire, ``e`` the new error."""
    total = g.float() + e.float()
    gq, scale = quantize_int8(total)
    gd = dequantize_int8(gq, scale, torch.float32)
    e.copy_(total - gd)
    g.copy_(gd)


def _update_leaf(p, g, m, v, lr, bc1, bc2, cfg: OptConfig):
    """One leaf's AdamW step, written into ``p``, ``m`` and ``v``, in the
    reference's order of operations:
    ``mf = b1·m + (1-b1)·g``, ``vf = b2·v + (1-b2)·g·g``,
    ``p - lr·(mf/bc1 / (sqrt(vf/bc2) + eps) + wd·p)``."""
    gf = g.float()
    mf = m if m.dtype == torch.float32 else m.float()
    mf.mul_(cfg.b1).add_(gf * (1 - cfg.b1))
    vf = v if v.dtype == torch.float32 else v.float()
    vf.mul_(cfg.b2).add_(gf * (1 - cfg.b2) * gf)
    if mf is not m:
        m.copy_(mf)
    if vf is not v:
        v.copy_(vf)
    upd = mf / bc1                                # mhat
    den = torch.div(vf, bc2).sqrt_().add_(cfg.eps)
    upd.div_(den)
    pf = p if p.dtype == torch.float32 else p.float()
    upd.add_(torch.mul(pf, cfg.weight_decay, out=den))
    pf.sub_(upd.mul_(lr))
    if pf is not p:
        p.copy_(pf)


def adamw_update(grads, opt_state, params, cfg: OptConfig, *,
                 donate: bool = True):
    """Returns ``(new_params, new_opt_state, metrics)`` with metrics
    ``grad_norm`` and ``lr`` (0-d tensors on the device).  A gradient
    leaf that is None (a parameter the loss does not reach) counts as
    zeros: its moments decay and its parameter is still decayed by the
    weight decay, as the reference's zero gradient is.  With ``donate``
    (the default) the parameters, the state's leaves and the gradients
    are written in place; without it, nothing given is written."""
    if not donate:
        params = tree_map(torch.clone, params)
        opt_state = tree_map(torch.clone, opt_state)
        grads = tree_map(lambda g: None if g is None else g.clone(), grads)
    grads = tree_map(lambda g, p: torch.zeros_like(p) if g is None else g,
                 grads, params)
    step = opt_state["step"] + 1
    lr = cosine_lr(step, cfg)
    metrics = {}
    if cfg.compress == "int8":
        # error-feedback compression of the (to-be-all-reduced) gradient
        for g, e in zip(leaves(grads), leaves(opt_state["err"])):
            _compress_(g, e)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, donate=True)
    metrics["grad_norm"] = gnorm
    metrics["lr"] = lr

    stepf = step.float()
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf
    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(opt_state["m"]), leaves(opt_state["v"])):
        _update_leaf(p, g, m, v, lr, bc1, bc2, cfg)
    new_state = {"m": opt_state["m"], "v": opt_state["v"], "step": step}
    if cfg.compress == "int8":
        new_state["err"] = opt_state["err"]
    return params, new_state, metrics
