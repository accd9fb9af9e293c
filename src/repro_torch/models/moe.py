"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch.

Counterpart of ``repro.models.moe``.  The router's softmax is f32 and
its top-k follows ``jax.lax.top_k``'s order (descending, the lower
expert first among equal probabilities: `core.dominance.topk_order`);
the gates are renormalised.  Dispatch is sort-free: a token's slot in
its expert's buffer comes from a cumsum over the one-hot assignment
(T*k, E), and the capacity is ``max(1, int(cf * T * k / E))``, computed
in Python floats as the reference does.  Tokens past an expert's
capacity are dropped: their destination is one row past the buffer,
which the scatter writes into an extra row that is cut off, and the
combine reads from an extra zero row, as the reference's ``mode="drop"``
scatter and ``mode="fill"`` gather do.

The reference's distributed branch (dispatch under ``shard_map`` per
data shard) is the sharding layer, ROADMAP item 14c: an enabled sharder
raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.dominance import topk_order
from repro_torch.models.common import PSpec

__all__ = ["moe_plan", "moe_apply", "moe_dispatch", "moe_capacity"]


def moe_plan(d_model: int, d_ff: int, n_experts: int,
             shared_expert: bool = False):
    plan = {
        "router": PSpec((d_model, n_experts), ("embed", "expert"), "scaled"),
        "wi": PSpec((n_experts, d_model, d_ff),
                    ("expert", "expert_embed", "expert_mlp"), "scaled"),
        "wg": PSpec((n_experts, d_model, d_ff),
                    ("expert", "expert_embed", "expert_mlp"), "scaled"),
        "wo": PSpec((n_experts, d_ff, d_model),
                    ("expert", "expert_mlp", "expert_embed"), "scaled"),
    }
    if shared_expert:
        plan["shared"] = {
            "wi": PSpec((d_model, d_ff), ("embed", "mlp"), "scaled"),
            "wg": PSpec((d_model, d_ff), ("embed", "mlp"), "scaled"),
            "wo": PSpec((d_ff, d_model), ("mlp", "embed"), "scaled"),
        }
    return plan


def moe_capacity(t: int, top_k: int, n_experts: int,
                 capacity_factor: float) -> int:
    """Slots per expert for ``t`` tokens, in the reference's Python
    float arithmetic."""
    return max(1, int(capacity_factor * t * top_k / n_experts))


def moe_dispatch(xt, choice, *, n_experts: int, top_k: int,
                 capacity_factor: float, compute_dtype):
    """xt: (T, D); choice: (T*k,) expert ids, token-major.  Returns the
    (E, cap, D) buffer, each choice's destination row (``E * cap`` when
    dropped) and whether it was kept."""
    t, d = xt.shape
    e = n_experts
    cap = moe_capacity(t, top_k, e, capacity_factor)
    onehot = F.one_hot(choice, e).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    mypos = torch.gather(pos, 1, choice[:, None])[:, 0]
    ok = mypos < cap
    dest = torch.where(ok, choice.to(torch.int32) * cap + mypos, e * cap)
    xrep = torch.repeat_interleave(xt, top_k, dim=0).to(compute_dtype)
    # one spare row takes every dropped token; it is cut off after
    buf = torch.zeros((e * cap + 1, d), dtype=compute_dtype,
                      device=xt.device)
    buf[dest.long()] = xrep
    return buf[:e * cap].reshape(e, cap, d), dest, ok


def _moe_combine(y, dest, gate, top_k: int):
    """Each choice's expert output (zero when dropped), gate-weighted and
    summed over the k choices of its token."""
    e, cap, d = y.shape
    yfl = torch.cat([y.reshape(e * cap, d), y.new_zeros((1, d))])
    ytok = yfl[dest.long()]
    t = dest.shape[0] // top_k
    return (ytok.reshape(t, top_k, d)
            * gate[..., None].to(y.dtype)).sum(dim=1)


def moe_apply(params, x, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25,
              compute_dtype=torch.bfloat16, sharder=None):
    """x: (B, S, D) -> (B, S, D), aux metrics dict."""
    if sharder is not None and getattr(sharder, "enabled", False):
        raise NotImplementedError(
            "the distributed MoE dispatch (per-shard capacity under a "
            "device mesh) is the sharding layer, ROADMAP item 14c")
    b, s, d = x.shape
    t = b * s
    e = n_experts
    dt = compute_dtype
    xt = x.reshape(t, d)

    logits = torch.matmul(xt.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    idx = topk_order(probs)[:, :top_k]                       # (T, k)
    gate = torch.gather(probs, 1, idx)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    buf, dest, ok = moe_dispatch(xt, idx.reshape(t * top_k), n_experts=e,
                                 top_k=top_k,
                                 capacity_factor=capacity_factor,
                                 compute_dtype=dt)

    # expert FFN (SwiGLU)
    h = torch.bmm(buf, params["wi"].to(dt))
    g = torch.bmm(buf, params["wg"].to(dt))
    y = torch.bmm(F.silu(h) * g, params["wo"].to(dt))
    out = _moe_combine(y, dest, gate, top_k)

    if "shared" in params:
        sh = params["shared"]
        xd = xt.to(dt)
        hh = torch.matmul(xd, sh["wi"].to(dt))
        gg = torch.matmul(xd, sh["wg"].to(dt))
        out = out + torch.matmul(F.silu(hh) * gg, sh["wo"].to(dt))

    # Switch-style load-balance aux loss terms
    frac = torch.mean(F.one_hot(idx[:, 0], e).float(), dim=0)
    pmean = torch.mean(probs, dim=0)
    aux = {"moe_aux_loss": e * torch.sum(frac * pmean),
           "moe_drop_frac": 1.0 - torch.mean(ok.float())}
    return out.reshape(b, s, d), aux
