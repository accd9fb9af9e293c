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
The router's product and the expert products are `common.product`s of
the shards, so the weights' rules (EP: experts over the model axis; TP:
the expert hidden dim over it) apply to them; over an FSDP axis the
smaller of weight and buffer is gathered.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.dominance import topk_order
from repro_torch.launch.mesh import local_map
from repro_torch.models.common import PSpec, placements, product

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
    if sharder is not None and sharder.enabled:
        return _moe_sharded(params, x, sharder, n_experts=n_experts,
                            top_k=top_k, capacity_factor=capacity_factor,
                            compute_dtype=compute_dtype)
    b, s, d = x.shape
    t = b * s
    e = n_experts
    dt = compute_dtype
    xt = x.reshape(t, d)

    logits = torch.matmul(xt.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    idx, gate = _route(probs, top_k)                         # (T, k)
    buf, dest, ok = moe_dispatch(xt, idx.reshape(-1), n_experts=e,
                                 top_k=top_k,
                                 capacity_factor=capacity_factor,
                                 compute_dtype=dt)
    y = _experts(params, buf, dt)
    out = _moe_combine(y, dest, gate, top_k)
    if "shared" in params:
        out = out + _shared(params["shared"], xt.to(dt), "t", dt)
    aux = _aux(idx, torch.mean(probs, dim=0), ok, e)
    return out.reshape(b, s, d), aux


def _experts(params, buf, dt):
    """The expert FFN (SwiGLU) on the (E, cap, D) buffer; distributed,
    `product`s of the shards: the weights keep their rules but over an
    FSDP axis, where the smaller of weight and buffer is gathered."""
    def mm(eq, a, w):
        return product(eq, a, w.to(dt), torch.matmul)

    h = mm("ecd,edf->ecf", buf, params["wi"])
    g = mm("ecd,edf->ecf", buf, params["wg"])
    return mm("ecf,efd->ecd", F.silu(h) * g, params["wo"])


def _shared(sh, xd, lead: str, dt):
    """The shared expert on ``xd``, whose leading dims are ``lead``."""
    def mm(eq, a, w):
        return product(eq, a, w.to(dt), torch.matmul)

    hh = mm(f"{lead}d,df->{lead}f", xd, sh["wi"])
    gg = mm(f"{lead}d,df->{lead}f", xd, sh["wg"])
    return mm(f"{lead}f,fd->{lead}d", F.silu(hh) * gg, sh["wo"])


def _aux(idx, pmean, ok, e: int) -> dict:
    """Switch-style load-balance aux loss terms."""
    experts = torch.arange(e, device=idx.device)
    frac = torch.mean((idx[:, :1] == experts).float(), dim=0)
    return {"moe_aux_loss": e * torch.sum(frac * pmean),
            "moe_drop_frac": 1.0 - torch.mean(ok.float())}


def _moe_sharded(params, x, sharder, *, n_experts, top_k, capacity_factor,
                 compute_dtype):
    """`moe_apply` with an enabled sharder: the routing, the dispatch and
    the combine on each token shard under ``local_map``, as the
    reference's shard_map bodies.  Between the bodies the tokens stay
    (B, S, ...), and each body flattens its own shard: DTensor cannot
    flatten a batch sharded unevenly (a microbatch of 8 rows over 16
    data ranks, where GSPMD pads), and the combine's output takes the
    input's global shape.  A flattened token shard (the choices, their
    destinations) is taken as even."""
    b, s, d = x.shape
    e, dt = n_experts, compute_dtype
    mesh = x.device_mesh
    tok = sharder.rules.get("batch")

    def on(*spec):
        return placements(spec, mesh)

    logits = product("bsd,de->bse", x.float(), params["router"].float(),
                     torch.matmul)
    probs = torch.softmax(logits, dim=-1)

    def route(p_l):
        return _route(p_l.reshape(-1, e), top_k)

    def dispatch(x_l, idx_l):
        return moe_dispatch(x_l.reshape(-1, d), idx_l.reshape(-1),
                            n_experts=e, top_k=top_k,
                            capacity_factor=capacity_factor,
                            compute_dtype=dt)

    def combine(y_l, dest_l, gate_l):
        return _moe_combine(y_l, dest_l, gate_l, top_k).reshape(-1, s, d)

    idx, gate = local_map(
        route, out_placements=(on(tok, None), on(tok, None)),
        in_placements=(on(tok, None, None),), device_mesh=mesh,
        redistribute_inputs=True)(probs)
    buf, dest, ok = local_map(
        dispatch, out_placements=(on(None, tok, None), on(tok), on(tok)),
        in_placements=(on(tok, None, None), on(tok, None)), device_mesh=mesh,
        redistribute_inputs=True)(x, idx)
    y = _experts(params, buf, dt).redistribute(mesh, on(None, tok, None))
    out = local_map(
        combine, out_placements=list(on(tok, None, None)),  # one output
        in_placements=(on(None, tok, None), on(tok), on(tok, None)),
        device_mesh=mesh, redistribute_inputs=True,
        out_shapes=(x.shape,))(y, dest, gate)
    if "shared" in params:
        out = out + _shared(params["shared"], x.to(dt), "bs", dt)
    return out, _aux(idx, torch.mean(probs, dim=(0, 1)), ok, e)
