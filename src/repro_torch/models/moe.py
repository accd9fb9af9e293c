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

Distributed (an enabled sharder; the parameters and ``x`` are
DTensors), the routing, the dispatch and the combine run on each token
shard alone under ``local_map``, the reference's ``shard_map`` bodies:
the tokens are sharded as the rules' ``batch`` axes say, each shard has
its own capacity ``max(1, int(cf * t_l * k / E))`` for its ``t_l``
tokens, and the (E, cap_l * shards, D) buffer is sharded on its slot dim.
So a distributed layer drops other tokens than a one-device layer does.
The router's product and the expert products stay on DTensors, so the
weights' rules (EP: experts over the model axis; TP: the expert hidden
dim over it) apply to them.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.core.dominance import topk_order
from repro_torch.launch.mesh import local_map
from repro_torch.models.common import PSpec, placements

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


def _route(probs, top_k: int):
    """The top-k choices (T, k) and their renormalised gates."""
    idx = topk_order(probs)[:, :top_k]
    gate = torch.gather(probs, 1, idx)
    return idx, gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)


def moe_apply(params, x, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25,
              compute_dtype=torch.bfloat16, sharder=None):
    """x: (B, S, D) -> (B, S, D), aux metrics dict."""
    b, s, d = x.shape
    t = b * s
    e = n_experts
    dt = compute_dtype
    xt = x.reshape(t, d)

    logits = torch.matmul(xt.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)

    def dispatch(xt_l, idx_l):
        return moe_dispatch(xt_l, idx_l.reshape(-1), n_experts=e,
                            top_k=top_k, capacity_factor=capacity_factor,
                            compute_dtype=dt)

    def combine(y_l, dest_l, gate_l):
        return _moe_combine(y_l, dest_l, gate_l, top_k)

    if sharder is not None and sharder.enabled:
        # per token shard, as the reference's shard_map bodies
        mesh = xt.device_mesh
        tok = sharder.rules.get("batch")

        def on(*spec):
            return placements(spec, mesh)

        idx, gate = local_map(
            functools.partial(_route, top_k=top_k),
            out_placements=(on(tok, None), on(tok, None)),
            in_placements=(on(tok, None),), device_mesh=mesh,
            redistribute_inputs=True)(probs)
        buf, dest, ok = local_map(
            dispatch, out_placements=(on(None, tok, None), on(tok), on(tok)),
            in_placements=(on(tok, None), on(tok, None)), device_mesh=mesh,
            redistribute_inputs=True)(xt, idx)
    else:
        idx, gate = _route(probs, top_k)                     # (T, k)
        buf, dest, ok = dispatch(xt, idx)

    # expert FFN (SwiGLU); distributed, the weights keep their rules
    h = torch.matmul(buf, params["wi"].to(dt))
    g = torch.matmul(buf, params["wg"].to(dt))
    y = torch.matmul(F.silu(h) * g, params["wo"].to(dt))

    if sharder is not None and sharder.enabled:
        y = y.redistribute(mesh, on(None, tok, None))
        out = local_map(
            combine, out_placements=list(on(tok, None)),  # one output
            in_placements=(on(None, tok, None), on(tok), on(tok, None)),
            device_mesh=mesh, redistribute_inputs=True)(y, dest, gate)
    else:
        out = combine(y, dest, gate)

    if "shared" in params:
        sh = params["shared"]
        xd = xt.to(dt)
        hh = torch.matmul(xd, sh["wi"].to(dt))
        gg = torch.matmul(xd, sh["wg"].to(dt))
        out = out + torch.matmul(F.silu(hh) * gg, sh["wo"].to(dt))

    # Switch-style load-balance aux loss terms
    experts = torch.arange(e, device=idx.device)
    frac = torch.mean((idx[:, :1] == experts).float(), dim=0)
    pmean = torch.mean(probs, dim=0)
    aux = {"moe_aux_loss": e * torch.sum(frac * pmean),
           "moe_drop_frac": 1.0 - torch.mean(ok.float())}
    return out.reshape(b, s, d), aux
