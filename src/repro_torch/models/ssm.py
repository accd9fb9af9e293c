"""Mamba-2 / SSD (state-space duality) block.

Counterpart of ``repro.models.ssm``.  Training and prefill use the
chunked SSD algorithm: an intra-chunk quadratic (attention-like) term,
per-chunk states, and the inter-chunk recurrence as a loop over chunks.
Decode is the constant-memory recurrent form.

Multi-head layout: x is (B, S, H, P) with a scalar decay A per head and
one B/C group shared across heads (n_groups = 1, as in Mamba-2).

SiLU in bf16 (`silu`) is rounded as the reference rounds it: its
``jax.nn.silu`` is ``x * logistic(x)`` with the logistic lowered to
``1 / (1 + exp(-x))``, each step a bf16 result, and the logistic's
derivative ``s * (1 - s)``.  ``F.silu`` rounds once from f32, which is
closer per element but another value: the block's gradients in bf16
are ill-conditioned (a gated RMSNorm over rows where the scan nearly
cancels the skip term, ``y ≈ -D·x``), and that difference alone put the
port's bf16 gradients up to 15x further from the reference than the
reference's own distance from f32.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import Partial, Replicate, local_map
from repro_torch.models.common import PSpec, placements, product, rmsnorm

__all__ = ["mamba2_plan", "mamba2_apply", "mamba2_decode", "SSMState",
           "init_ssm_state", "silu"]

_CONV_W = 4  # causal conv width, as in Mamba-2


class _SiluBF16(torch.autograd.Function):
    """``x * s`` with ``s = 1 / (1 + exp(-x))``, every step rounded to
    bf16; backward ``g * s + (g * x) * (s * (1 - s))``, as JAX
    differentiates ``x * logistic(x)``."""

    @staticmethod
    def forward(ctx, x):
        s = torch.reciprocal(1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1 - s))


def silu(x):
    """SiLU; in bf16 rounded step by step as the reference's program
    rounds it (see the module docstring)."""
    if x.dtype == torch.bfloat16:
        return _SiluBF16.apply(x)
    return F.silu(x)


def mamba2_plan(d_model: int, n_heads: int, head_dim: int, state: int):
    """d_inner = n_heads * head_dim (expand factor folded into n_heads)."""
    return {
        "wz": PSpec((d_model, n_heads, head_dim),
                    ("embed", "heads", "head_dim"), "scaled"),
        "wx": PSpec((d_model, n_heads, head_dim),
                    ("embed", "heads", "head_dim"), "scaled"),
        "wB": PSpec((d_model, state), ("embed", "state"), "scaled"),
        "wC": PSpec((d_model, state), ("embed", "state"), "scaled"),
        "wdt": PSpec((d_model, n_heads), ("embed", "heads"), "scaled"),
        "dt_bias": PSpec((n_heads,), ("heads",), "zeros"),
        "A_log": PSpec((n_heads,), ("heads",), "zeros"),
        "D": PSpec((n_heads,), ("heads",), "ones"),
        "conv_x": PSpec((_CONV_W, n_heads, head_dim),
                        ("conv", "heads", "head_dim"), "scaled"),
        "conv_B": PSpec((_CONV_W, state), ("conv", "state"), "scaled"),
        "conv_C": PSpec((_CONV_W, state), ("conv", "state"), "scaled"),
        "norm": PSpec((n_heads, head_dim), ("heads", "head_dim"), "zeros"),
        "wo": PSpec((n_heads, head_dim, d_model),
                    ("heads", "head_dim", "embed"), "scaled"),
    }


class SSMState(NamedTuple):
    h: torch.Tensor        # (B, H, P, N) recurrent state, f32
    conv_x: torch.Tensor   # (B, _CONV_W-1, H, P) conv tail
    conv_B: torch.Tensor   # (B, _CONV_W-1, N)
    conv_C: torch.Tensor   # (B, _CONV_W-1, N)


def init_ssm_state(batch, n_heads, head_dim, state, dtype=torch.float32,
                   device=None):
    return SSMState(
        h=torch.zeros((batch, n_heads, head_dim, state),
                      dtype=torch.float32, device=device),
        conv_x=torch.zeros((batch, _CONV_W - 1, n_heads, head_dim),
                           dtype=dtype, device=device),
        conv_B=torch.zeros((batch, _CONV_W - 1, state), dtype=dtype,
                           device=device),
        conv_C=torch.zeros((batch, _CONV_W - 1, state), dtype=dtype,
                           device=device))


def _causal_conv(x, kernel):
    """x: (B, S, ...); kernel: (W, ...) depthwise causal conv + SiLU."""
    w = kernel.shape[0]
    s = x.shape[1]
    acc = x * kernel[-1]
    for i in range(1, w):
        zeros = x.new_zeros((x.shape[0], min(i, s)) + x.shape[2:])
        shifted = torch.cat([zeros, x[:, :max(s - i, 0)]], dim=1)
        acc = acc + shifted * kernel[w - 1 - i]
    return silu(acc)


def _segsum(x):
    """x: (..., L). out[..., i, j] = sum_{j < k <= i} x_k, lower-tri;
    -inf above the diagonal."""
    n = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    tri = torch.tril(torch.ones((n, n), dtype=torch.bool, device=x.device))
    return torch.where(tri, seg, -torch.inf)


def _ssd_scan(xdt, dtA, b_in, c_in, chunk: int):
    """Chunked SSD core.

    xdt: (B, S, H, P) inputs pre-multiplied by dt
    dtA: (B, S, H) per-step log-decay (dt * A, negative)
    b_in/c_in: (B, S, N)
    Returns y: (B, S, H, P), final_state: (B, H, P, N).
    """
    bsz, s, h, p = xdt.shape
    n = b_in.shape[-1]
    assert s % chunk == 0, (s, chunk)
    c = s // chunk
    xc = xdt.reshape(bsz, c, chunk, h, p)
    ac = dtA.reshape(bsz, c, chunk, h).permute(0, 1, 3, 2)   # (B,C,H,L)
    bc = b_in.reshape(bsz, c, chunk, n)
    cc = c_in.reshape(bsz, c, chunk, n)

    # intra-chunk (quadratic, attention-like)
    L = torch.exp(_segsum(ac))                               # (B,C,H,L,L)
    y_diag = torch.einsum("bcln,bcmn,bchlm,bcmhp->bclhp", cc, bc, L, xc)

    # per-chunk states to pass across the boundary
    cum = torch.cumsum(ac, dim=-1)                           # (B,C,H,L)
    decay_states = torch.exp(cum[..., -1:] - cum)
    states = torch.einsum("bcln,bchl,bclhp->bchpn", bc, decay_states, xc)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cum[..., -1])                    # (B,C,H)
    hcur = xdt.new_zeros((bsz, h, p, n))
    hprevs = []
    for i in range(c):
        hprevs.append(hcur)
        hcur = hcur * chunk_decay[:, i, :, None, None] + states[:, i]
    hprevs = torch.stack(hprevs, dim=1)                      # (B,C,H,P,N)

    state_decay = torch.exp(cum)                             # (B,C,H,L)
    y_off = torch.einsum("bcln,bchpn,bchl->bclhp", cc, hprevs, state_decay)
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y, hcur


def _ssm_core(xi, z, bi, ci, dt_raw, conv_x, conv_B, conv_C, dt_bias,
              A_log, D, *, chunk, compute_dtype):
    """The block from its input projections to its gated output, before
    the norm: the causal convolutions, the SSD scan, the skip and the
    gate.  Returns (y, final state, pre-conv tails of x, B and C).  It
    is separable over the batch, the heads and the head_dim, so that a
    rank runs it on its shards alone (`_sharded_core`)."""
    dt_ = compute_dtype
    s = xi.shape[1]
    # pre-conv tails for decode continuation
    tail_x = xi[:, -(_CONV_W - 1):]
    tail_B = bi[:, -(_CONV_W - 1):]
    tail_C = ci[:, -(_CONV_W - 1):]
    xi = _causal_conv(xi, conv_x)
    bi = _causal_conv(bi, conv_B)
    ci = _causal_conv(ci, conv_C)

    dt = F.softplus(dt_raw + dt_bias.float())
    A = -torch.exp(A_log.float())                            # (H,) < 0
    dtA = dt * A[None, None, :]                              # (B,S,H)

    xdt = xi.float() * dt[..., None]
    # pad the sequence to a chunk multiple with state-neutral steps
    # (dtA = 0 -> decay 1; xdt = 0 -> no state update)
    pad = (-s) % chunk

    def padz(a):
        if not pad:
            return a
        return torch.cat([a, a.new_zeros((a.shape[0], pad) + a.shape[2:])],
                         dim=1)

    y, hfinal = _ssd_scan(padz(xdt), padz(dtA), padz(bi.float()),
                          padz(ci.float()), chunk)
    y = y[:, :s]
    y = y + xi.float() * D.float()[None, None, :, None]
    return y.to(dt_) * silu(z), hfinal, tail_x, tail_B, tail_C


# logical axes of `_ssm_core`'s arguments and results, and of
# `_decode_core`'s
_CORE_IN = (("batch", None, "heads", None), ("batch", None, "heads", None),
            ("batch", None, None), ("batch", None, None),
            ("batch", None, "heads"), (None, "heads", None), (None, None),
            (None, None), ("heads",), ("heads",), ("heads",))
_CORE_OUT = (("batch", None, "heads", None), ("batch", "heads", None, None),
             ("batch", None, "heads", None), ("batch", None, None),
             ("batch", None, None))
_DECODE_IN = (("batch", "heads", None), ("batch", "heads", None),
              ("batch", None), ("batch", None), ("batch", "heads"),
              ("batch", "heads", None, None), ("batch", None, "heads", None),
              ("batch", None, None), ("batch", None, None),
              (None, "heads", None), (None, None), (None, None), ("heads",),
              ("heads",), ("heads",))
_DECODE_OUT = (("batch", "heads", None), ("batch", "heads", None, None),
               ("batch", None, "heads", None), ("batch", None, None),
               ("batch", None, None))


def _sharded_core(core, sharder, in_axes, out_axes, *args):
    """``core`` on each rank's shards under ``local_map``, its arguments
    and results placed by the rules of their logical axes: x and z as
    the reference constrains them (batch, heads; the head_dim whole), B
    and C whole but for the batch, each parameter as the heads shard it.
    A rank's gradient of an argument that is whole over a mesh dim that
    shards another one is a partial sum over that dim.  As DTensor
    operations, the scan's loop over chunks would dispatch some thousand
    operations a layer through DTensor's sharding propagation, which on
    a 3-D mesh does not end in useful time."""
    mesh = args[0].device_mesh

    def on(axes):
        return placements(sharder.spec(*axes), mesh)

    ins = tuple(on(a) for a in in_axes)
    split = {i for pl in ins for i, p in enumerate(pl) if p.is_shard()}
    grads = tuple(tuple(p if p.is_shard() else
                        Partial() if i in split else Replicate()
                        for i, p in enumerate(pl)) for pl in ins)
    return local_map(core, out_placements=tuple(on(a) for a in out_axes),
                     in_placements=ins, in_grad_placements=grads,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def mamba2_apply(params, x, *, n_heads, head_dim, state, chunk=128,
                 compute_dtype=torch.bfloat16, sharder=None, unroll=False):
    """Full-sequence Mamba-2 block (train / prefill).

    x: (B, S, D) -> (B, S, D), final SSMState (for decode continuation).
    """
    del n_heads, head_dim, state, unroll
    dt_ = compute_dtype
    xd = x.to(dt_)
    z = product("bsd,dhp->bshp", xd, params["wz"].to(dt_))
    xi = product("bsd,dhp->bshp", xd, params["wx"].to(dt_))
    bi = product("bsd,dn->bsn", xd, params["wB"].to(dt_))
    ci = product("bsd,dn->bsn", xd, params["wC"].to(dt_))
    dt_raw = product("bsd,dh->bsh", x.float(), params["wdt"].float())

    args = (xi, z, bi, ci, dt_raw, params["conv_x"].to(dt_),
            params["conv_B"].to(dt_), params["conv_C"].to(dt_),
            params["dt_bias"], params["A_log"], params["D"])
    core = functools.partial(_ssm_core, chunk=chunk, compute_dtype=dt_)
    if sharder is not None and sharder.enabled:
        # the reference constrains the convolved x and z to (batch, heads);
        # the convolution is per channel, so x is constrained before it
        y, hfinal, tail_x, tail_B, tail_C = _sharded_core(
            core, sharder, _CORE_IN, _CORE_OUT, *args)
    else:
        y, hfinal, tail_x, tail_B, tail_C = core(*args)
    y = rmsnorm(y, params["norm"])
    out = product("bshp,hpd->bsd", y.to(dt_), params["wo"].to(dt_))

    ssm_state = SSMState(h=hfinal.float(), conv_x=tail_x.to(dt_),
                         conv_B=tail_B.to(dt_), conv_C=tail_C.to(dt_))
    return out, ssm_state


def _conv_step(tail, cur, kern):
    """Causal conv over (tail ++ current): the SiLU'd output and the new
    tail."""
    hist = torch.cat([tail, cur[:, None]], dim=1)            # (B, W, ...)
    out = torch.einsum("bw...,w...->b...", hist, kern)
    return silu(out), hist[:, 1:]


def _decode_core(xi, z, bi, ci, dt_raw, h, tail_x, tail_B, tail_C, conv_x,
                 conv_B, conv_C, dt_bias, A_log, D, *, compute_dtype):
    """One recurrent step from the input projections to the gated
    output, before the norm: (y, new state h, new conv tails).
    Separable as `_ssm_core` is."""
    xi, ncx = _conv_step(tail_x, xi, conv_x)
    bi, ncb = _conv_step(tail_B, bi, conv_B)
    ci, ncc = _conv_step(tail_C, ci, conv_C)

    dt = F.softplus(dt_raw + dt_bias.float())
    A = -torch.exp(A_log.float())
    decay = torch.exp(dt * A[None, :])                       # (B,H)

    xf = xi.float()
    bf = bi.float()
    h_new = (h * decay[..., None, None]
             + torch.einsum("bhp,bn->bhpn", xf * dt[..., None], bf))
    y = torch.einsum("bhpn,bn->bhp", h_new, ci.float())
    y = y + xf * D.float()[None, :, None]
    return y.to(compute_dtype) * silu(z), h_new, ncx, ncb, ncc


def mamba2_decode(params, x, st: SSMState, *, n_heads, head_dim, state,
                  compute_dtype=torch.bfloat16, sharder=None):
    """Single-token recurrent step. x: (B, 1, D) -> (B, 1, D), new state.
    With an enabled sharder the step runs on each rank's shards, as
    `mamba2_apply`'s core does."""
    del n_heads, head_dim, state
    dt_ = compute_dtype
    xt = x[:, 0]
    xd = xt.to(dt_)
    z = product("bd,dhp->bhp", xd, params["wz"].to(dt_))
    xi = product("bd,dhp->bhp", xd, params["wx"].to(dt_))
    bi = product("bd,dn->bn", xd, params["wB"].to(dt_))
    ci = product("bd,dn->bn", xd, params["wC"].to(dt_))
    dt_raw = product("bd,dh->bh", xt.float(), params["wdt"].float())

    args = (xi, z, bi, ci, dt_raw, st.h, st.conv_x, st.conv_B, st.conv_C,
            params["conv_x"].to(dt_), params["conv_B"].to(dt_),
            params["conv_C"].to(dt_), params["dt_bias"], params["A_log"],
            params["D"])
    core = functools.partial(_decode_core, compute_dtype=dt_)
    if sharder is not None and sharder.enabled:
        y, h_new, ncx, ncb, ncc = _sharded_core(core, sharder, _DECODE_IN,
                                                _DECODE_OUT, *args)
    else:
        y, h_new, ncx, ncb, ncc = core(*args)
    y = rmsnorm(y, params["norm"])
    out = product("bhp,hpd->bd", y.to(dt_), params["wo"].to(dt_))
    return out[:, None], SSMState(h_new, ncx, ncb, ncc)
