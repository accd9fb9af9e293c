"""Attention: GQA/MQA/MHA with RoPE/NoPE, qk-norm, full / sliding-window /
chunked-local / prefix-LM masking, blockwise (online-softmax) execution
for long sequences, and static-shape KV caches (full and rolling) for
decode.

Counterpart of ``repro.models.attention``, in plain torch operations
(the reference computes this math outside any kernel).  Layout: q is
(B, Hq, S, Dh) after the projection, k/v (B, Hkv, S, Dh); the query
heads of one KV head are consecutive (``repeat_interleave``, as
``jnp.repeat``).  Logits and softmax are f32, with an additive -1e30
mask.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.launch.mesh import (DTensor, Partial, Replicate, Shard,
                                     local_map)
from repro_torch.models.common import PSpec, placements, product, rmsnorm

__all__ = ["attn_plan", "init_rope", "apply_rope", "mask_block",
           "attention_train", "init_cache", "cache_from_prefill",
           "attention_decode", "KVCache", "MASK_KINDS"]

MASK_KINDS = ("causal", "window", "chunk", "bidir", "prefix")
_NEG = -1e30


def attn_plan(d_model: int, n_heads: int, n_kv: int, head_dim: int,
              qk_norm: bool = False):
    plan = {
        "wq": PSpec((d_model, n_heads, head_dim),
                    ("embed", "heads", "head_dim"), "scaled"),
        "wk": PSpec((d_model, n_kv, head_dim),
                    ("embed", "kv_heads", "head_dim"), "scaled"),
        "wv": PSpec((d_model, n_kv, head_dim),
                    ("embed", "kv_heads", "head_dim"), "scaled"),
        "wo": PSpec((n_heads, head_dim, d_model),
                    ("heads", "head_dim", "embed"), "scaled"),
    }
    if qk_norm:
        plan["q_norm"] = PSpec((head_dim,), ("head_dim",), "zeros")
        plan["k_norm"] = PSpec((head_dim,), ("head_dim",), "zeros")
    return plan


# --------------------------------------------------------------------------
# RoPE (split halves, not interleaved)
# --------------------------------------------------------------------------

def init_rope(head_dim: int, theta: float = 1e4, device=None):
    """The (Dh/2,) f32 inverse frequencies ``theta ** (-2i / Dh)``."""
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=device) / head_dim
    return torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=device), exps)


def apply_rope(x, positions, freqs):
    """x: (..., S, Dh); positions: (S,) or broadcastable."""
    ang = positions[..., :, None].float() * freqs            # (S, Dh/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Masks, pointwise over (q_pos, k_pos)
# --------------------------------------------------------------------------

def mask_block(kind: str, q_pos, k_pos, *, window: int = 0, chunk: int = 0,
               prefix_len=None):
    """(Sq, Bk) bool tile of the attention mask."""
    q = q_pos[:, None]
    k = k_pos[None, :]
    causal = k <= q
    if kind == "causal":
        return causal
    if kind == "window":
        return causal & (q - k < window)
    if kind == "chunk":
        return causal & (q // chunk == k // chunk)
    if kind == "bidir":
        return torch.ones_like(causal)
    if kind == "prefix":
        return causal | (k < prefix_len)
    raise ValueError(kind)


# --------------------------------------------------------------------------
# Projections
# --------------------------------------------------------------------------

def _proj_in(x, w):
    """``einsum("bsd,dhk->bshk")``; on DTensors a `product` of the
    shards, ``x`` whole along its sequence."""
    return product("bsd,dhk->bshk", x, w)


def _proj_out(o, w):
    """``einsum("bshk,hkd->bsd")``; on DTensors a `product` of the
    shards: a partial sum over the axis that shards the heads or the
    head_dim (``o`` is moved onto the weight's shards)."""
    return product("bshk,hkd->bsd", o, w)


def _project_qkv(params, x, dt, qk_norm):
    xd = x.to(dt)
    q = _proj_in(xd, params["wq"].to(dt))
    k = _proj_in(xd, params["wk"].to(dt))
    v = _proj_in(xd, params["wv"].to(dt))
    if qk_norm:
        q = rmsnorm(q, params["q_norm"])
        k = rmsnorm(k, params["k_norm"])
    return q, k, v


def _repeat_kv(k, n_heads):
    """(B, Hkv, S, Dh) -> (B, Hq, S, Dh): each KV head repeated for its
    group of consecutive query heads (``jnp.repeat``)."""
    g = n_heads // k.shape[1]
    if g == 1:
        return k
    return torch.repeat_interleave(k, g, dim=1)


# --------------------------------------------------------------------------
# Training / prefill attention
# --------------------------------------------------------------------------

def _mask_bias(mask):
    return torch.where(mask, 0.0, _NEG)


def _attn_full(q, k, v, mask):
    """q/k/v: (B, Hq, S, Dh); mask: (Sq, Sk)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float()
    logits = logits * scale + _mask_bias(mask)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v)


def _attn_blockwise(q, k, v, kind, *, window, chunk, prefix_len, block_k,
                    q_pos=None):
    """Online-softmax loop over key blocks (no (S, S) buffer); ``q_pos``
    the queries' positions (default ``0..Sq-1``)."""
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    assert sk % block_k == 0, (sk, block_k)
    scale = dh ** -0.5
    if q_pos is None:
        q_pos = torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=q.device)
    for i in range(sk // block_k):
        kblk = k[:, :, i * block_k:(i + 1) * block_k]
        vblk = v[:, :, i * block_k:(i + 1) * block_k]
        k_pos = i * block_k + torch.arange(block_k, device=q.device)
        msk = mask_block(kind, q_pos, k_pos, window=window, chunk=chunk,
                         prefix_len=prefix_len)
        logits = torch.einsum("bhqd,bhkd->bhqk", q, kblk).float() * scale \
            + _mask_bias(msk)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(vblk.dtype), vblk).float()
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def _attn_core(q, k, v, q_pos, *, kind, window, chunk, prefix_len,
               block_k, blockwise):
    """Attention of the queries at ``q_pos`` over all the keys."""
    if blockwise:
        return _attn_blockwise(q, k, v, kind, window=window, chunk=chunk,
                               prefix_len=prefix_len, block_k=block_k,
                               q_pos=q_pos)
    k_pos = torch.arange(k.shape[2], device=k.device)
    return _attn_full(q, k, v, mask_block(kind, q_pos, k_pos, window=window,
                                          chunk=chunk,
                                          prefix_len=prefix_len))


def _sharded_core(core, sharder, q, k, v, pos):
    """``core`` on each rank's shard under ``local_map``: the queries as
    the rules shard them (batch, heads, attn_seq), the keys and values
    whole along the sequence (gathered where kv_seq shards them: XLA
    keeps them sharded and reduces the softmax across shards instead).
    DTensor's own products would merge the batch and heads dims, which
    torch 2.11's DTensor refuses when the heads are sharded."""
    mesh = q.device_mesh
    qpl = placements(sharder.spec("batch", "heads", "attn_seq", None), mesh)
    kpl = placements(sharder.spec("batch", "heads", None, None), mesh)
    ppl = placements(sharder.spec("attn_seq"), mesh)
    # a rank's key and value gradients cover its own queries only: a
    # partial sum over the axis that shards the queries' sequence
    kgrad = tuple(Partial() if p == Shard(2) else k_
                  for p, k_ in zip(qpl, kpl))
    return local_map(core, out_placements=list(qpl),    # one output
                     in_placements=(qpl, kpl, kpl, ppl),
                     in_grad_placements=(qpl, kgrad, kgrad, ppl),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, sharder.place(pos, "attn_seq"))


def attention_train(params, x, *, n_heads, n_kv, head_dim, compute_dtype,
                    rope_freqs=None, kind="causal", window=0, chunk=0,
                    prefix_len=None, qk_norm=False, block_k: int = 1024,
                    blockwise_threshold: int = 8192, sharder=None,
                    unroll=False):
    """Self-attention over a full sequence (train / prefill).  Returns
    ((k, v) as (B, Hkv, S, Dh), y)."""
    del n_kv, head_dim, unroll
    s = x.shape[1]
    q, k, v = _project_qkv(params, x, compute_dtype, qk_norm)
    pos = torch.arange(s, device=x.device)
    qg = q.transpose(1, 2)                     # (B,Hq,S,Dh)
    kh = k.transpose(1, 2)                     # (B,Hkv,S,Dh)
    vh = v.transpose(1, 2)
    if sharder is not None:
        # heads over the model axis where they divide it, else the
        # sequence (attn_seq): the quadratic intermediates shard either
        # way; K/V before the GQA repeat, which then stays local.
        # Before RoPE, which is elementwise: RoPE's halves of a
        # head_dim-sharded q would gather all of q first
        qg = sharder(qg, "batch", "heads", "attn_seq", None)
        kh = sharder(kh, "batch", "kv_heads", "kv_seq", None)
        vh = sharder(vh, "batch", "kv_heads", "kv_seq", None)
    if rope_freqs is not None:
        qg = apply_rope(qg, pos, rope_freqs)
        kh = apply_rope(kh, pos, rope_freqs)
    kf = _repeat_kv(kh, n_heads)
    vf = _repeat_kv(vh, n_heads)
    core = functools.partial(
        _attn_core, kind=kind, window=window, chunk=chunk,
        prefix_len=prefix_len, block_k=block_k,
        blockwise=s > blockwise_threshold)
    if sharder is not None and sharder.enabled:
        out = _sharded_core(core, sharder, qg, kf, vf, pos)
    else:
        out = core(qg, kf, vf, pos)
    if sharder is not None:    # (B,Hq,S,Dh): the reference's (B,S,Hq,Dh)
        out = sharder(out, "batch", "heads", "attn_seq", None)
    y = _proj_out(out.transpose(1, 2).to(compute_dtype),
                     params["wo"].to(compute_dtype))
    return (kh, vh), y


# --------------------------------------------------------------------------
# Decode: static-shape KV caches
# --------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Static-shape KV cache; ``rolling`` is static (not a tensor).
    Stacked caches carry a leading layer axis on every tensor."""
    k: torch.Tensor      # (B, W, Hkv, Dh)
    v: torch.Tensor      # (B, W, Hkv, Dh)
    kpos: torch.Tensor   # (W,) int32 absolute positions, -1 = empty
    rolling: bool

    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)


def init_cache(batch: int, capacity: int, n_kv: int, head_dim: int,
               dtype, rolling: bool, device=None) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, capacity, n_kv, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, capacity, n_kv, head_dim), dtype=dtype,
                      device=device),
        kpos=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        rolling=rolling)


def _roll(t, shift: int, dim: int):
    """``torch.roll`` along ``dim``; a DTensor (torch 2.11's has no
    sharding strategy for ``roll``) is rolled on each rank with ``dim``
    gathered, then placed back."""
    if not isinstance(t, DTensor):
        return torch.roll(t, shift, dims=dim)
    d = dim % t.ndim
    mesh = t.device_mesh
    whole = tuple(Replicate() if p.is_shard(d) else p for p in t.placements)
    out = local_map(lambda x: torch.roll(x, shift, dims=d),
                    out_placements=list(whole), in_placements=(whole,),
                    device_mesh=mesh, redistribute_inputs=True)(t)
    return out.redistribute(mesh, t.placements)


def cache_from_prefill(k, v, capacity: int, rolling: bool) -> KVCache:
    """k/v: (..., B, Hkv, S, Dh) from attention_train, with any leading
    (layer) axes: keep the last ``capacity`` positions.  A rolling cache
    is a ring rotated so that absolute position p sits in slot
    p % capacity; kpos carries the leading axes too."""
    s = k.shape[-2]
    lead = k.shape[:-4]
    kk = k.transpose(-3, -2)                    # (..., B, S, Hkv, Dh)
    vv = v.transpose(-3, -2)
    take = min(s, capacity)
    start = s - take
    pad = capacity - take
    dev = k.device

    def padded(t):
        t = t[..., start:, :, :]
        if pad == 0:
            return t.contiguous()
        z = t.new_zeros(t.shape[:-3] + (pad,) + t.shape[-2:])
        return torch.cat([t, z], dim=-3)

    kpos = torch.cat([torch.arange(start, s, dtype=torch.int32, device=dev),
                      torch.full((pad,), -1, dtype=torch.int32,
                                 device=dev)])
    kc, vc = padded(kk), padded(vv)
    if rolling and start % capacity:
        shift = start % capacity
        kc = _roll(kc, shift, -3)
        vc = _roll(vc, shift, -3)
        kpos = torch.roll(kpos, shift)
    return KVCache(kc, vc, kpos.expand(lead + (capacity,)).contiguous(),
                   rolling=rolling)


def attention_decode(params, x, cache: KVCache, pos, *, n_heads, n_kv,
                     head_dim, compute_dtype, rope_freqs=None,
                     kind="causal", window=0, chunk=0, qk_norm=False,
                     sharder=None):
    """One-token decode step. x: (B, 1, D); pos: 0-d int32 tensor (or an
    int), the absolute position.  Returns (new_cache, y)."""
    del n_heads
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor(pos, dtype=torch.int32, device=x.device)
    pos = pos.to(torch.int32)
    q, k, v = _project_qkv(params, x, compute_dtype, qk_norm)
    if rope_freqs is not None:
        pvec = pos.reshape(1)
        q = apply_rope(q.transpose(1, 2), pvec, rope_freqs).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), pvec, rope_freqs).transpose(1, 2)

    w = cache.k.shape[1]
    slot = torch.remainder(pos, w) if cache.rolling else torch.clamp(
        pos, max=w - 1)
    # the write is a select, as in the reference
    sel = torch.arange(w, device=x.device) == slot
    new = cache._replace(
        k=torch.where(sel[None, :, None, None], k.to(cache.k.dtype),
                      cache.k),
        v=torch.where(sel[None, :, None, None], v.to(cache.v.dtype),
                      cache.v),
        kpos=torch.where(sel, pos, cache.kpos))
    if sharder is not None:
        new = new._replace(
            k=sharder(new.k, "batch", "kv_seq", "kv_heads", None),
            v=sharder(new.v, "batch", "kv_seq", "kv_heads", None))

    # grouped-query attention against the unrepeated cache
    b_, _, hq, dh_ = q.shape
    g = hq // n_kv
    qg = q.reshape(b_, n_kv, g, dh_)                    # (B,Hkv,G,Dh)
    kh = new.k.transpose(1, 2)                          # (B,Hkv,W,Dh)
    vh = new.v.transpose(1, 2)
    kpos = new.kpos
    valid = kpos >= 0
    if kind == "window" and window:
        valid &= (pos - kpos) < window
    if kind == "chunk" and chunk:
        valid &= (kpos // chunk) == (pos // chunk)
    valid &= kpos <= pos

    scale = head_dim ** -0.5
    logits = torch.einsum("bhgd,bhkd->bhgk", qg, kh).float()
    logits = logits * scale + _mask_bias(valid)
    wts = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", wts.to(vh.dtype), vh)
    out = out.reshape(b_, 1, hq, dh_)                   # (B,1,Hq,Dh)
    y = _proj_out(out.to(compute_dtype),
                     params["wo"].to(compute_dtype))
    return new, y
