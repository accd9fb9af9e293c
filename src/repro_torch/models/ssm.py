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

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import PSpec, rmsnorm

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


def mamba2_apply(params, x, *, n_heads, head_dim, state, chunk=128,
                 compute_dtype=torch.bfloat16, sharder=None, unroll=False):
    """Full-sequence Mamba-2 block (train / prefill).

    x: (B, S, D) -> (B, S, D), final SSMState (for decode continuation).
    """
    del n_heads, head_dim, state, sharder, unroll
    dt_ = compute_dtype
    s = x.shape[1]
    xd = x.to(dt_)
    z = torch.einsum("bsd,dhp->bshp", xd, params["wz"].to(dt_))
    xi = torch.einsum("bsd,dhp->bshp", xd, params["wx"].to(dt_))
    bi = torch.einsum("bsd,dn->bsn", xd, params["wB"].to(dt_))
    ci = torch.einsum("bsd,dn->bsn", xd, params["wC"].to(dt_))
    dt_raw = torch.einsum("bsd,dh->bsh", x.float(), params["wdt"].float())

    # pre-conv tails for decode continuation
    tail_x = xi[:, -(_CONV_W - 1):]
    tail_B = bi[:, -(_CONV_W - 1):]
    tail_C = ci[:, -(_CONV_W - 1):]
    xi = _causal_conv(xi, params["conv_x"].to(dt_))
    bi = _causal_conv(bi, params["conv_B"].to(dt_))
    ci = _causal_conv(ci, params["conv_C"].to(dt_))

    dt = F.softplus(dt_raw + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())                  # (H,) < 0
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
    y = y + xi.float() * params["D"].float()[None, None, :, None]
    y = y.to(dt_) * silu(z)
    y = rmsnorm(y, params["norm"])
    out = torch.einsum("bshp,hpd->bsd", y.to(dt_), params["wo"].to(dt_))

    ssm_state = SSMState(h=hfinal.float(), conv_x=tail_x.to(dt_),
                         conv_B=tail_B.to(dt_), conv_C=tail_C.to(dt_))
    return out, ssm_state


def _conv_step(tail, cur, kern):
    """Causal conv over (tail ++ current): the SiLU'd output and the new
    tail."""
    hist = torch.cat([tail, cur[:, None]], dim=1)            # (B, W, ...)
    out = torch.einsum("bw...,w...->b...", hist, kern)
    return silu(out), hist[:, 1:]


def mamba2_decode(params, x, st: SSMState, *, n_heads, head_dim, state,
                  compute_dtype=torch.bfloat16, sharder=None):
    """Single-token recurrent step. x: (B, 1, D) -> (B, 1, D), new state."""
    del n_heads, head_dim, state, sharder
    dt_ = compute_dtype
    xt = x[:, 0]
    xd = xt.to(dt_)
    z = torch.einsum("bd,dhp->bhp", xd, params["wz"].to(dt_))
    xi = torch.einsum("bd,dhp->bhp", xd, params["wx"].to(dt_))
    bi = torch.einsum("bd,dn->bn", xd, params["wB"].to(dt_))
    ci = torch.einsum("bd,dn->bn", xd, params["wC"].to(dt_))
    dt_raw = torch.einsum("bd,dh->bh", xt.float(), params["wdt"].float())

    xi, ncx = _conv_step(st.conv_x, xi, params["conv_x"].to(dt_))
    bi, ncb = _conv_step(st.conv_B, bi, params["conv_B"].to(dt_))
    ci, ncc = _conv_step(st.conv_C, ci, params["conv_C"].to(dt_))

    dt = F.softplus(dt_raw + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    decay = torch.exp(dt * A[None, :])                       # (B,H)

    xf = xi.float()
    bf = bi.float()
    h_new = (st.h * decay[..., None, None]
             + torch.einsum("bhp,bn->bhpn", xf * dt[..., None], bf))
    y = torch.einsum("bhpn,bn->bhp", h_new, ci.float())
    y = y + xf * params["D"].float()[None, :, None]
    y = y.to(dt_) * silu(z)
    y = rmsnorm(y, params["norm"])
    out = torch.einsum("bhp,hpd->bd", y.to(dt_), params["wo"].to(dt_))
    return out[:, None], SSMState(h_new, ncx, ncb, ncc)
