"""Model zoo wiring: decoder LMs (dense / MoE / iRoPE-MoE), pure-SSM,
hybrid SSM+shared-attention, encoder-only, and VLM (prefix-LM), all built
from the layer library over stacked layer parameters.

Counterpart of ``repro.models.transformer``.  The parameter tree is the
reference's (`lm_plan`: the same nested dict keys, a leading layer axis
on every stacked block), and the caches are the reference's pytrees:
dicts of stacked `KVCache` / `SSMState`.  Where the reference scans
over the layer axis, the port loops over it in Python, one layer's
parameters (views of the stacked tensors) at a time; in bf16 compute
each product casts its own weight, so no second copy of the model is
held.  Everything runs where the parameters lie.

Sharded, the parameters are DTensors over a ``DeviceMesh`` and an
enabled `Sharder` constrains the activations at the reference's sites
(the residual stream after the embedding and after every block, the
attention's q/k/v and output, the KV cache's write, the Mamba-2 block's
x and z, the MoE's token shards).  Where the rules shard the residual
stream's sequence (``seq``: the heads do not divide the model axis),
the port also says what GSPMD infers: each block's normed input is
gathered along the sequence before its products, and each block's
output (the attention's, the MLP's or MoE's, the Mamba-2 block's) is
constrained to the residual stream's placements before the add, which
reduce-scatters its partial sums (Megatron-SP).  Every product of an
activation and a weight is a `common.product`.  The forward then runs under
``implicit_replication``: the constants it makes (positions, masks,
RoPE tables) are plain tensors, the same on every rank, which DTensor
takes as replicated, as XLA does.

Public surface:
  lm_plan(cfg)                              parameter plan
  forward(params, cfg, inputs, ...)         logits (train/encoder fwd)
  loss_fn(params, cfg, batch, ...)          scalar loss + metrics
  prefill(params, cfg, inputs, cache_len)   caches + last-position logits
  decode_step(params, cfg, caches, token, pos)  one-token decode
  init_caches(cfg, batch, cache_len, ...)   decode-state tree (+factory)
  cache_axes(cfg, batch, cache_len)         (shape, dtype, axes) per leaf
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.mesh import (Partial, Replicate, Shard,
                                     distribute_tensor, implicit_replication,
                                     local_map)
from repro_torch.models import attention as att
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (PSpec, Sharder, cross_entropy,
                                       placements, product, rmsnorm,
                                       stack_plan)
from repro_torch.models.config import ModelConfig

__all__ = ["lm_plan", "forward", "loss_fn", "prefill", "decode_step",
           "init_caches", "cache_axes", "tree_map"]


def _dt(cfg: ModelConfig):
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32


# ==========================================================================
# Trees of tensors: dicts, lists, tuples, named tuples and KV caches
# ==========================================================================

def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of ``rest``, which share
    its structure), as ``jax.tree.map`` over the model's trees."""
    if isinstance(tree, att.KVCache):
        return att.KVCache(
            *(fn(*xs) for xs in zip(
                (tree.k, tree.v, tree.kpos),
                *((r.k, r.v, r.kpos) for r in rest))),
            rolling=tree.rolling)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _layer(tree, i):
    return tree_map(lambda a: a[i], tree)


def _unstack(tree, n: int) -> list:
    """The ``n`` per-layer trees of a stacked parameter tree: one
    ``unbind`` per leaf, whose backward writes the layers' gradients
    into the stacked gradient at once (a ``select`` per layer would
    each write a zero-filled gradient of the whole stack)."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    assert tree.shape[0] == n, (tree.shape, n)
    return list(tree.unbind(0))


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


# ==========================================================================
# Parameter plans
# ==========================================================================

def _mlp_plan(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    plan = {"wi": PSpec((d, f), ("embed", "mlp"), "scaled"),
            "wo": PSpec((f, d), ("mlp", "embed"), "scaled")}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        plan["wg"] = PSpec((d, f), ("embed", "mlp"), "scaled")
    return plan


def _attn_block_plan(cfg: ModelConfig, moe: bool):
    plan = {
        "ln1": PSpec((cfg.d_model,), ("embed",), "zeros"),
        "attn": att.attn_plan(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim_eff, cfg.qk_norm),
        "ln2": PSpec((cfg.d_model,), ("embed",), "zeros"),
    }
    if moe:
        plan["moe"] = moe_mod.moe_plan(cfg.d_model, cfg.d_ff, cfg.n_experts,
                                       cfg.shared_expert)
    else:
        plan["mlp"] = _mlp_plan(cfg)
    return plan


def _ssm_block_plan(cfg: ModelConfig):
    return {"ln": PSpec((cfg.d_model,), ("embed",), "zeros"),
            "mamba": ssm_mod.mamba2_plan(cfg.d_model, cfg.ssm_heads,
                                         cfg.ssm_head_dim, cfg.ssm_state)}


def lm_plan(cfg: ModelConfig):
    v, d = cfg.vocab_padded, cfg.d_model
    plan: dict[str, Any] = {
        "embed": PSpec((v, d), ("vocab", "embed"), "normal"),
        "final_norm": PSpec((d,), ("embed",), "zeros"),
    }
    if not cfg.tie_embeddings:
        plan["lm_head"] = PSpec((d, v), ("embed", "vocab"), "normal")
    if cfg.frontend_dim:
        plan["frontend_proj"] = PSpec((cfg.frontend_dim, d),
                                      (None, "embed"), "scaled")

    fam = cfg.family
    if fam in ("dense", "encoder", "vlm"):
        plan["blocks"] = stack_plan(_attn_block_plan(cfg, False),
                                    cfg.n_layers)
    elif fam == "moe" and cfg.global_every:
        # iRoPE super-layers: one stacked plan per sub-position
        period = cfg.global_every
        assert cfg.n_layers % period == 0, (cfg.n_layers, period)
        plan["blocks"] = {
            f"sub{i}": stack_plan(_attn_block_plan(cfg, is_moe),
                                  cfg.n_layers // period)
            for i, (_, is_moe) in enumerate(cfg.sub_pattern())}
    elif fam == "moe":
        assert cfg.moe_every == 1
        plan["blocks"] = stack_plan(_attn_block_plan(cfg, True),
                                    cfg.n_layers)
    elif fam == "ssm":
        plan["blocks"] = stack_plan(_ssm_block_plan(cfg), cfg.n_layers)
    elif fam == "hybrid":
        plan["blocks"] = stack_plan(_ssm_block_plan(cfg), cfg.n_layers)
        plan["shared_attn"] = _attn_block_plan(cfg, False)
    else:
        raise ValueError(fam)
    return plan


# ==========================================================================
# Block applications (full-sequence)
# ==========================================================================

def _mlp_apply(params, x, cfg, dt):
    """The MLP; on DTensors its products are `product`s: ``x`` whole
    along the sequence in, a partial sum over the ``mlp`` axis out."""
    xd = x.to(dt)

    def mm(eq, a, w):
        return product(eq, a, w.to(dt), torch.matmul)

    h = mm("bsd,df->bsf", xd, params["wi"])
    if cfg.mlp_kind == "swiglu":
        h = F.silu(h) * mm("bsd,df->bsf", xd, params["wg"])
    elif cfg.mlp_kind == "geglu":
        # jax.nn.gelu is the tanh approximation by default
        h = F.gelu(h, approximate="tanh") * mm("bsd,df->bsf", xd,
                                                params["wg"])
    else:
        h = F.gelu(h, approximate="tanh")
    return mm("bsf,fd->bsd", h, params["wo"])


def _attn_block(params, x, *, cfg, sharder, kind, use_rope, rope_freqs,
                prefix_len=None, is_moe=False):
    """Full-sequence attention block -> (x, (k, v), aux).  Where the
    rules shard the residual stream's sequence (``seq``), each half of
    the block is Megatron-SP's: its input gathered along the sequence,
    its output's partial sums reduce-scattered back onto it."""
    dt = _dt(cfg)
    h = _gather_seq(rmsnorm(x, params["ln1"]), sharder)
    kv, a = att.attention_train(
        params["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim_eff, compute_dtype=dt,
        rope_freqs=rope_freqs if use_rope else None, kind=kind,
        window=cfg.window, chunk=cfg.chunk, prefix_len=prefix_len,
        qk_norm=cfg.qk_norm, block_k=cfg.attn_block_k,
        blockwise_threshold=cfg.blockwise_threshold, sharder=sharder)
    # DTensor keeps the heads' partial sums lazy through the residual
    # add and the norm's scaling, and would then gather the MLP weights;
    # GSPMD sums them here, as this constraint does
    a = sharder(a, "batch", "seq", "act_embed")
    x = x + a.to(x.dtype)
    h = _gather_seq(rmsnorm(x, params["ln2"]), sharder)
    aux = {}
    if is_moe:
        f, aux = moe_mod.moe_apply(
            params["moe"], h, n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, compute_dtype=dt,
            sharder=sharder)
    else:
        f = _mlp_apply(params["mlp"], h, cfg, dt)
    f = sharder(f, "batch", "seq", "act_embed")
    x = x + f.to(x.dtype)
    return sharder(x, "batch", "seq", "act_embed"), kv, aux


def _gather_seq(h, sharder):
    """The block's input whole along the sequence: an all-gather where
    the rules' ``seq`` shards the residual stream, else nothing."""
    return sharder(h, "batch", None, "act_embed")


def _ssm_block(params, x, *, cfg, sharder):
    h = _gather_seq(rmsnorm(x, params["ln"]), sharder)
    y, state = ssm_mod.mamba2_apply(
        params["mamba"], h, n_heads=cfg.ssm_heads,
        head_dim=cfg.ssm_head_dim, state=cfg.ssm_state,
        chunk=cfg.ssm_chunk, compute_dtype=_dt(cfg), sharder=sharder)
    y = sharder(y, "batch", "seq", "act_embed")
    x = x + y.to(x.dtype)
    return sharder(x, "batch", "seq", "act_embed"), state


# ==========================================================================
# Embedding / head
# ==========================================================================

def _embed_lookup(embed, tokens, dt, sharder=None):
    """Row gather, then the cast (the reference casts the table first:
    the same values); sharded, `_sharded_lookup`."""
    if sharder is not None and sharder.enabled:
        return _sharded_lookup(embed, tokens, sharder).to(dt)
    return F.embedding(tokens.long(), embed).to(dt)


def _masked_rows(table, tokens, ids):
    """The rows of ``table`` (the vocab ids ``ids``, contiguous) that
    ``tokens`` name; zeros for a token outside them."""
    lo, n = ids[:1], table.shape[0]
    local = tokens.long() - lo
    inside = (local >= 0) & (local < n)
    rows = F.embedding(torch.where(inside, local, 0), table)
    return torch.where(inside[..., None], rows, torch.zeros_like(rows))


def _sharded_lookup(embed, tokens, sharder):
    """The lookup on each rank's shard of the table (a vocab-parallel
    embedding, under ``local_map``): a rank reads the tokens that fall in
    its rows and writes zeros for the rest, and the shards' results are a
    partial sum over the mesh axes that shard the vocab.  DTensor's own
    rules for ``embedding`` give a masked partial whose gradient meets the
    tied head's plain partial sum in the table's gradient, which
    torch 2.11 cannot add; here both are plain sums."""
    mesh = embed.device_mesh
    table = tuple(embed.placements)
    tok_in, out = [], []
    for i, (p, t) in enumerate(zip(table, placements(
            sharder.spec("batch", "seq"), mesh))):
        if p.is_shard(0):                  # vocab rows: a partial sum
            tok_in.append(Replicate())
            out.append(Partial())
        elif p.is_shard(1):                # embed columns
            tok_in.append(Replicate())
            out.append(Shard(tokens.ndim))
        else:
            tok_in.append(t)
            out.append(t)
    id_pl = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in table)
    ids = distribute_tensor(
        torch.arange(embed.shape[0], device=tokens.device), mesh, id_pl,
        src_data_rank=None)
    # each rank's gradient of its rows sums over its own tokens: a partial
    # sum over the axes that shard the tokens
    grad = tuple(Partial() if t.is_shard() and not p.is_shard() else p
                 for p, t in zip(table, tok_in))
    return local_map(_masked_rows, out_placements=out,
                     in_placements=(table, tuple(tok_in), id_pl),
                     in_grad_placements=(grad, tuple(tok_in), id_pl),
                     device_mesh=mesh, redistribute_inputs=True)(
        embed, tokens, ids)


def _embed_inputs(params, cfg, inputs, sharder):
    dt = _dt(cfg)
    if cfg.family == "encoder":
        x = product("bsf,fd->bsd", inputs["frames"].to(dt),
                    params["frontend_proj"].to(dt), torch.matmul)
    elif cfg.family == "vlm":
        img = product("bsf,fd->bsd", inputs["image_emb"].to(dt),
                      params["frontend_proj"].to(dt), torch.matmul)
        txt = _embed_lookup(params["embed"], inputs["tokens"], dt, sharder)
        # both whole along the sequence (and over the vocab's partial
        # sums) before the concatenation
        x = torch.cat([_gather_seq(img, sharder),
                       _gather_seq(txt, sharder)], dim=1)
    else:
        x = _embed_lookup(params["embed"], inputs["tokens"], dt, sharder)
    return sharder(x, "batch", "seq", "act_embed")


def _head(params, cfg, x, sharder, last_only: bool = False):
    dt = _dt(cfg)
    x = _gather_seq(x, sharder)
    if last_only:
        x = x[:, -1:]
    x = rmsnorm(x, params["final_norm"]).to(dt)
    if cfg.tie_embeddings:
        # contract against the (V, D) table: padded ids get logits too
        return product("bsd,vd->bsv", x, params["embed"].to(dt),
                       lambda a, w: torch.matmul(a, w.t())).float()
    return product("bsd,dv->bsv", x, params["lm_head"].to(dt),
                   torch.matmul).float()


def _rope(cfg, device):
    return att.init_rope(cfg.head_dim_eff, cfg.rope_theta, device=device)


# ==========================================================================
# Forward (train / encoder / prefill collection)
# ==========================================================================

def _builds_graph(params) -> bool:
    """Whether a forward over ``params`` records an autograd graph."""
    if not torch.is_grad_enabled():
        return False
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, torch.Tensor) and node.requires_grad:
            return True
    return False


def _maybe_remat(fn, cfg: ModelConfig, graph: bool):
    """``fn``, or ``fn`` under activation checkpointing when ``cfg.remat``
    and the forward builds a graph: where the reference wraps a block in
    ``jax.checkpoint``, its activations are recomputed in the backward
    pass instead of kept.  A forward with no graph (prefill, decode,
    ``torch.no_grad``) runs ``fn`` as it is."""
    if not (cfg.remat and graph):
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _sharded(sharder):
    """``(sharder, context)``: a disabled sharder for None, and the
    context a forward runs in (``implicit_replication`` when enabled)."""
    sharder = sharder or Sharder(enabled=False)
    return sharder, (implicit_replication() if sharder.enabled
                     else contextlib.nullcontext())


def forward(params, cfg: ModelConfig, inputs, *, sharder=None,
            collect_kv: bool = False, last_only: bool = False):
    """Returns (logits, collected, aux). collected is family-specific:
    stacked (k, v) or SSM states when collect_kv (prefill), else None.
    With ``cfg.remat``, a forward that builds an autograd graph
    recomputes each block in the backward pass, where the reference
    remats.  With an enabled ``sharder`` the parameters and inputs are
    DTensors, and so are the results."""
    sharder, ctx = _sharded(sharder)
    with ctx:
        return _forward(params, cfg, inputs, sharder, collect_kv, last_only)


def _forward(params, cfg, inputs, sharder, collect_kv, last_only):
    x = _embed_inputs(params, cfg, inputs, sharder)
    rope_freqs = _rope(cfg, x.device)
    prefix_len = cfg.prefix_len if cfg.family == "vlm" else None
    kind = ("bidir" if cfg.family == "encoder"
            else "prefix" if cfg.family == "vlm" else cfg.attn_kind)
    fam = cfg.family
    collected = None
    aux_sum = {}
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    graph = _builds_graph(params)

    if fam in ("dense", "encoder", "vlm") or (fam == "moe"
                                              and not cfg.global_every):
        is_moe = fam == "moe"
        blk = _maybe_remat(functools.partial(
            _attn_block, cfg=cfg, sharder=sharder, kind=kind, use_rope=True,
            rope_freqs=rope_freqs, prefix_len=prefix_len, is_moe=is_moe),
            cfg, graph)
        kvs, auxs = [], []
        for p in _unstack(params["blocks"], cfg.n_layers):
            x, kv, aux = blk(p, x)
            if collect_kv:
                kvs.append(kv)
            auxs.append(aux.get("moe_aux_loss", zero))
        collected = _stack(kvs) if collect_kv else None
        aux_sum["moe_aux_loss"] = torch.stack(auxs).sum()

    elif fam == "moe":  # iRoPE super-layers (llama4)
        pattern = cfg.sub_pattern()

        def superlayer(p, x):
            kvs = []
            a_sum = zero
            for i, (is_global, is_moe) in enumerate(pattern):
                x, kv, aux = _attn_block(
                    p[f"sub{i}"], x, cfg=cfg, sharder=sharder,
                    kind="causal" if is_global else "chunk",
                    use_rope=not is_global, rope_freqs=rope_freqs,
                    is_moe=is_moe)
                kvs.append(kv)
                a_sum = a_sum + aux.get("moe_aux_loss", zero)
            return x, kvs, a_sum

        blk = _maybe_remat(superlayer, cfg, graph)
        kvs = [[] for _ in pattern]
        auxs = []
        nsup = cfg.n_layers // cfg.global_every
        for p in _unstack(params["blocks"], nsup):
            x, kv, a_sum = blk(p, x)
            if collect_kv:
                for i, one in enumerate(kv):
                    kvs[i].append(one)
            auxs.append(a_sum)
        collected = [_stack(k) for k in kvs] if collect_kv else None
        aux_sum["moe_aux_loss"] = torch.stack(auxs).sum()

    elif fam == "ssm":
        blk = _maybe_remat(functools.partial(_ssm_block, cfg=cfg,
                                             sharder=sharder), cfg, graph)
        states = []
        for p in _unstack(params["blocks"], cfg.n_layers):
            x, st = blk(p, x)
            if collect_kv:
                states.append(st)
        collected = _stack(states) if collect_kv else None

    elif fam == "hybrid":
        # the shared attention block once per `attn_every` mamba layers
        period = cfg.attn_every
        shared = params["shared_attn"]
        attn_once = _maybe_remat(functools.partial(
            _attn_block, cfg=cfg, sharder=sharder, kind="causal",
            use_rope=True, rope_freqs=rope_freqs), cfg, graph)
        blk = _maybe_remat(functools.partial(_ssm_block, cfg=cfg,
                                             sharder=sharder), cfg, graph)
        layers = _unstack(params["blocks"], cfg.n_layers)
        states, kvs = [], []
        for app in range(cfg.n_attn_apps):
            x, kv, _ = attn_once(shared, x)
            if collect_kv:
                kvs.append(kv)
            for p in layers[app * period:app * period + period]:
                x, st = blk(p, x)
                if collect_kv:
                    states.append(st)
        collected = (_stack(states), _stack(kvs)) if collect_kv else None
    else:
        raise ValueError(fam)

    logits = _head(params, cfg, x, sharder, last_only=last_only)
    return logits, collected, aux_sum


def loss_fn(params, cfg: ModelConfig, batch, *, sharder=None):
    sharder, ctx = _sharded(sharder)
    with ctx:
        return _loss(params, cfg, batch, sharder)


def _loss(params, cfg, batch, sharder):
    logits, _, aux = forward(params, cfg, batch, sharder=sharder)
    labels = batch["labels"]
    if cfg.family == "vlm":  # loss only over text positions
        logits = logits[:, cfg.prefix_len:]
    mask = labels >= 0
    loss = cross_entropy(logits, torch.clamp(labels, min=0), mask)
    metrics = {"ce_loss": loss}
    if aux.get("moe_aux_loss") is not None and cfg.n_experts:
        loss = loss + 0.01 * aux["moe_aux_loss"] / max(cfg.n_layers, 1)
        metrics["moe_aux_loss"] = aux["moe_aux_loss"]
    metrics["loss"] = loss
    return loss, metrics


# ==========================================================================
# Decode: cache construction and single-token step
# ==========================================================================

def init_caches(cfg: ModelConfig, batch: int, cache_len: int, *,
                factory=None, device=None):
    """Decode-state tree.  ``factory(shape, dtype, axes)`` makes each
    leaf; by default zeros on ``device`` (the card unless ``"cpu"``).
    An encoder has no decode step: ``ValueError``."""
    if factory is None:
        dev = resolve_device(device)

        def factory(shape, dtype, axes):
            del axes
            return torch.zeros(shape, dtype=dtype, device=dev)

    dt = _dt(cfg)
    dh, hk = cfg.head_dim_eff, cfg.n_kv_heads

    def kv(n_stack, width, rolling):
        def mk(s, d, a):
            return factory((n_stack,) + s, d, ("layer",) + a)
        return att.KVCache(
            k=mk((batch, width, hk, dh), dt,
                 ("batch", "kv_seq", "kv_heads", None)),
            v=mk((batch, width, hk, dh), dt,
                 ("batch", "kv_seq", "kv_heads", None)),
            kpos=mk((width,), torch.int32, ("kv_seq",)),
            rolling=rolling)

    def ssm(n_stack):
        def mk(s, d, a):
            return factory((n_stack,) + s, d, ("layer",) + a)
        return ssm_mod.SSMState(
            h=mk((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                 torch.float32, ("batch", "heads", None, None)),
            conv_x=mk((batch, 3, cfg.ssm_heads, cfg.ssm_head_dim), dt,
                      ("batch", None, "heads", None)),
            conv_B=mk((batch, 3, cfg.ssm_state), dt, ("batch", None, None)),
            conv_C=mk((batch, 3, cfg.ssm_state), dt, ("batch", None, None)))

    fam = cfg.family
    if fam in ("dense", "vlm") or (fam == "moe" and not cfg.global_every):
        rolling = cfg.attn_kind == "window" and 0 < cfg.window < cache_len
        width = min(cache_len, cfg.window) if rolling else cache_len
        return {"kv": kv(cfg.n_layers, width, rolling)}
    if fam == "moe":  # llama4 iRoPE
        nsup = cfg.n_layers // cfg.global_every
        caches = {}
        for i, (is_global, _) in enumerate(cfg.sub_pattern()):
            if is_global:
                caches[f"sub{i}"] = kv(nsup, cache_len, rolling=False)
            else:
                caches[f"sub{i}"] = kv(nsup, min(cache_len, cfg.chunk),
                                       rolling=True)
        return caches
    if fam == "ssm":
        return {"ssm": ssm(cfg.n_layers)}
    if fam == "hybrid":
        return {"ssm": ssm(cfg.n_layers),
                "attn": kv(cfg.n_attn_apps, cache_len, rolling=False)}
    raise ValueError(f"{fam} has no decode step")


def cache_axes(cfg, batch, cache_len):
    """``(shape, dtype, axes)`` per leaf of `init_caches`' tree."""
    return init_caches(cfg, batch, cache_len,
                       factory=lambda s, d, a: (s, d, a))


def _attn_decode_block(params, x, cache, pos, cfg, sharder, *, kind,
                       use_rope, rope_freqs, is_moe):
    dt = _dt(cfg)
    h = rmsnorm(x, params["ln1"])
    cache, a = att.attention_decode(
        params["attn"], h, cache, pos, n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim_eff, compute_dtype=dt,
        rope_freqs=rope_freqs if use_rope else None, kind=kind,
        window=cfg.window, chunk=cfg.chunk, qk_norm=cfg.qk_norm,
        sharder=sharder)
    a = sharder(a, "batch", None, "act_embed")   # as in _attn_block
    x = x + a.to(x.dtype)
    h = rmsnorm(x, params["ln2"])
    if is_moe:
        f, _ = moe_mod.moe_apply(
            params["moe"], h, n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=max(cfg.capacity_factor, 2.0),
            compute_dtype=dt, sharder=sharder)
    else:
        f = _mlp_apply(params["mlp"], h, cfg, dt)
    return cache, x + f.to(x.dtype)


def _ssm_decode_block(params, x, st, cfg, sharder):
    h = rmsnorm(x, params["ln"])
    y, st = ssm_mod.mamba2_decode(
        params["mamba"], h, st, n_heads=cfg.ssm_heads,
        head_dim=cfg.ssm_head_dim, state=cfg.ssm_state,
        compute_dtype=_dt(cfg), sharder=sharder)
    return x + y.to(x.dtype), st


def decode_step(params, cfg: ModelConfig, caches, token, pos, *,
                sharder=None):
    """One-token decode. token: (B, 1) integer; pos: 0-d int32 tensor
    (or an int), the position of the new token.  Returns (new_caches,
    logits (B, vocab_padded)).  Sharded as `forward`."""
    sharder, ctx = _sharded(sharder)
    with ctx:
        return _decode_step(params, cfg, caches, token, pos, sharder)


def _decode_step(params, cfg, caches, token, pos, sharder):
    dt = _dt(cfg)
    x = _embed_lookup(params["embed"], token, dt, sharder)
    x = sharder(x, "batch", None, "act_embed")
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor(pos, dtype=torch.int32, device=x.device)
    rope_freqs = _rope(cfg, x.device)
    fam = cfg.family

    if fam in ("dense", "vlm") or (fam == "moe" and not cfg.global_every):
        kind = "causal" if fam == "vlm" else cfg.attn_kind
        new = []
        for i in range(cfg.n_layers):
            c, x = _attn_decode_block(
                _layer(params["blocks"], i), x, _layer(caches["kv"], i),
                pos, cfg, sharder, kind=kind, use_rope=True,
                rope_freqs=rope_freqs, is_moe=fam == "moe")
            new.append(c)
        new_caches = {"kv": _stack(new)}

    elif fam == "moe":  # llama4
        pattern = cfg.sub_pattern()
        new = {f"sub{i}": [] for i in range(len(pattern))}
        for j in range(cfg.n_layers // cfg.global_every):
            for i, (is_global, is_moe) in enumerate(pattern):
                name = f"sub{i}"
                c, x = _attn_decode_block(
                    _layer(params["blocks"][name], j), x,
                    _layer(caches[name], j), pos, cfg, sharder,
                    kind="causal" if is_global else "chunk",
                    use_rope=not is_global, rope_freqs=rope_freqs,
                    is_moe=is_moe)
                new[name].append(c)
        new_caches = {k: _stack(v) for k, v in new.items()}

    elif fam == "ssm":
        new = []
        for i in range(cfg.n_layers):
            x, st = _ssm_decode_block(_layer(params["blocks"], i), x,
                                      _layer(caches["ssm"], i), cfg, sharder)
            new.append(st)
        new_caches = {"ssm": _stack(new)}

    elif fam == "hybrid":
        # attention at the application boundaries only
        period = cfg.attn_every
        shared = params["shared_attn"]
        new_attn, new_ssm = [], []
        for app in range(cfg.n_attn_apps):
            cache, x = _attn_decode_block(
                shared, x, _layer(caches["attn"], app), pos, cfg, sharder,
                kind="causal", use_rope=True, rope_freqs=rope_freqs,
                is_moe=False)
            new_attn.append(cache)
            for i in range(app * period,
                           min(app * period + period, cfg.n_layers)):
                x, st = _ssm_decode_block(_layer(params["blocks"], i), x,
                                          _layer(caches["ssm"], i), cfg,
                                          sharder)
                new_ssm.append(st)
        new_caches = {"ssm": _stack(new_ssm), "attn": _stack(new_attn)}
    else:
        raise ValueError(fam)

    logits = _head(params, cfg, x, sharder, last_only=True)[:, 0]
    return new_caches, logits


# ==========================================================================
# Prefill: full forward that also builds the decode caches
# ==========================================================================

def prefill(params, cfg: ModelConfig, inputs, cache_len: int, *,
            sharder=None):
    """Process a prompt, return (caches, last-position logits)."""
    sharder, ctx = _sharded(sharder)
    with ctx:
        return _prefill(params, cfg, inputs, cache_len, sharder)


def _prefill(params, cfg, inputs, cache_len, sharder):
    logits, collected, _ = forward(params, cfg, inputs, sharder=sharder,
                                   collect_kv=True, last_only=True)
    fam = cfg.family

    def build_kv(kvs, width, rolling):
        k, v = kvs  # each (L, B, H, S, Dh)
        return att.cache_from_prefill(k, v, width, rolling)

    if fam in ("dense", "vlm") or (fam == "moe" and not cfg.global_every):
        rolling = cfg.attn_kind == "window" and 0 < cfg.window < cache_len
        width = min(cache_len, cfg.window) if rolling else cache_len
        caches = {"kv": build_kv(collected, width, rolling)}
    elif fam == "moe":
        caches = {}
        for i, (is_global, _) in enumerate(cfg.sub_pattern()):
            if is_global:
                caches[f"sub{i}"] = build_kv(collected[i], cache_len, False)
            else:
                caches[f"sub{i}"] = build_kv(
                    collected[i], min(cache_len, cfg.chunk), True)
    elif fam == "ssm":
        caches = {"ssm": collected}
    elif fam == "hybrid":
        states, kvs = collected  # kvs already stacked per application
        caches = {"ssm": states, "attn": build_kv(kvs, cache_len, False)}
    else:
        raise ValueError(f"{fam} has no decode step")
    return caches, logits[:, -1]
