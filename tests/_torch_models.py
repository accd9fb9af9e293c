"""Shared helpers of the language-model parity tests
(``tests/test_torch_{transformer,attention,moe,ssm,serve_lm}.py``).

Both packages get the same parameters: the port's CPU ``init_params``
from a seed, as numpy arrays (the reference's own initialisation folds
Python's per-process salted ``hash`` into its keys, so it would change
the inputs from run to run).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.models.common import init_params

# the reference's own tolerances (tests/test_models_smoke.py:82-91)
F32_TOL = 1e-4
BF16_TOL = 3e-2
BF16_DECODE_TOL = 4e-2


def configs(arch, **kw):
    """(port config, reference config), both smoke-sized, with ``kw``
    replaced in each."""
    return (dataclasses.replace(tget(arch, smoke=True), **kw),
            dataclasses.replace(jget(arch, smoke=True), **kw))


def params_pair(cfg, seed=0):
    """(port params on the CPU, the same arrays as JAX arrays)."""
    params = init_params(TT.lm_plan(cfg), seed=seed, device="cpu")
    host = convert.params_to_numpy(params)
    return params, jax.tree.map(jnp.asarray, host)


def inputs_pair(cfg, b, s, seed=0):
    """Prompt inputs of ``s`` text positions (after a VLM's image
    prefix), the next token, and the position of that token:
    (port inputs, reference inputs, next token (B, 1), its position)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    host = {}
    if cfg.family == "encoder":
        host["frames"] = rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)
    else:
        host["tokens"] = toks[:, :s]
    if cfg.family == "vlm":
        host["image_emb"] = rng.standard_normal(
            (b, cfg.prefix_len, cfg.frontend_dim)).astype(np.float32)
    pos = s + (cfg.prefix_len if cfg.family == "vlm" else 0)
    return ({k: torch.from_numpy(v) for k, v in host.items()},
            {k: jnp.asarray(v) for k, v in host.items()},
            toks[:, s:s + 1], pos)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, tol, what=""):
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol,
                               err_msg=what)


def assert_bits(got, want, what=""):
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want)
    assert g.shape == w.shape and g.dtype.itemsize == w.dtype.itemsize, what
    np.testing.assert_array_equal(g.view(f"i{g.dtype.itemsize}"),
                                  w.view(f"i{w.dtype.itemsize}"),
                                  err_msg=what)


def cache_leaves(tree):
    """[(path, leaf)] of a cache tree of either package, leaves in the
    order (k, v, kpos) or SSMState's fields."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (list,)):
            for i, x in enumerate(t):
                walk(x, path + (i,))
        elif hasattr(t, "kpos"):
            for f in ("k", "v", "kpos"):
                out.append((path + (f,), getattr(t, f)))
        else:
            for f in ("h", "conv_x", "conv_B", "conv_C"):
                out.append((path + (f,), getattr(t, f)))

    walk(tree, ())
    return out


def reference_caches(host_tree):
    """The port's cache tree with numpy leaves as the reference's
    KVCache / SSMState objects."""
    from repro.models import attention as jatt
    from repro.models import ssm as jssm
    if isinstance(host_tree, dict):
        return {k: reference_caches(v) for k, v in host_tree.items()}
    if hasattr(host_tree, "kpos"):
        return jatt.KVCache(jnp.asarray(host_tree.k),
                            jnp.asarray(host_tree.v),
                            jnp.asarray(host_tree.kpos),
                            rolling=host_tree.rolling)
    return jssm.SSMState(*(jnp.asarray(x) for x in host_tree))


def record_routing(monkeypatch):
    """Record every top-k routing choice the reference makes from now
    on, jitted or not (an ordered ``jax.debug.callback`` reads each
    choice as it is made, inside the layer scan too); returns the list
    that fills.  In bf16 a token whose top-1 and top-2 router
    probabilities lie within rounding of each other can pick another
    expert in either package, or in two compilations of the reference;
    replaying the reference's choices in the port (`replay_routing`)
    leaves the arithmetic to compare."""
    recorded = []
    orig = jax.lax.top_k

    def top_k(x, k):
        gate, idx = orig(x, k)
        jax.debug.callback(lambda i: recorded.append(np.asarray(i)), idx,
                           ordered=True)
        return gate, idx

    monkeypatch.setattr(jax.lax, "top_k", top_k)
    return recorded


def replay_routing(monkeypatch, recorded):
    """The port's MoE layers take the recorded choices, in order, in
    place of their own top-k; returns the queue (empty once all were
    used)."""
    queue = list(recorded)

    def order(merit):
        idx = torch.from_numpy(queue.pop(0).astype(np.int64))
        assert idx.shape[0] == merit.shape[0]
        return idx.to(merit.device)

    monkeypatch.setattr(tmoe, "topk_order", order)
    return queue


def force_routing(monkeypatch, recorded):
    """The reference's MoE layers take the recorded choices, in order
    (an ordered ``io_callback`` hands out the next one, inside the
    layer scan too; the gates are gathered from the router's
    probabilities); returns the queue."""
    from jax.experimental import io_callback
    queue = list(recorded)

    def top_k(x, k):
        shape = jax.ShapeDtypeStruct(x.shape[:-1] + (k,), jnp.int32)
        idx = io_callback(lambda: queue.pop(0).astype(np.int32), shape,
                          ordered=True)
        return jnp.take_along_axis(x, idx, axis=-1), idx

    monkeypatch.setattr(jax.lax, "top_k", top_k)
    return queue


def op_by_op(fn, *args):
    """``fn(*args)`` compiled by XLA without excess precision: every
    operation's bf16 result is rounded, as when the reference runs op by
    op (``jax.disable_jit``; the same bits, measured) and as torch
    rounds each operation's result."""
    return jax.jit(fn, compiler_options={
        "xla_allow_excess_precision": False})(*args)


def assert_bf16_within_own_error(got, want, want_f32, what=""):
    """bf16 parity, norm-wise over the arrays given: the distance
    between two bf16 runs is at most the distance of the reference's
    bf16 run from its f32 run on the same inputs and routing (bf16's
    own error)."""
    g, w, f = (np.concatenate([np32(x).ravel() for x in xs])
               for xs in (got, want, want_f32))
    assert g.shape == w.shape == f.shape, what
    dist, own = np.linalg.norm(g - w), np.linalg.norm(w - f)
    assert np.isfinite(g).all() and dist <= own, (
        f"{what}: |port - reference| = {dist} > |reference bf16 - f32| = "
        f"{own}")
    return dist / own


# -- one forward, prefill and decode step of each package -----------------

B, S, CACHE_LEN = 2, 20, 32


def reference_run(jcfg, jparams, jin, tok, pos, batch=None):
    """forward, prefill and one decode step of the reference (and the
    loss when given a batch), in one function."""
    from repro.models import transformer as JT
    logits, _, aux = JT.forward(jparams, jcfg, jin)
    out = {"logits": logits, "aux": aux}
    if batch is not None:
        out["loss"] = JT.loss_fn(jparams, jcfg, batch)
    if jcfg.family != "encoder":
        caches, last = JT.prefill(jparams, jcfg, jin, CACHE_LEN)
        new, dec = JT.decode_step(jparams, jcfg, caches, tok, jnp.int32(pos))
        out.update(caches=caches, last=last, new_caches=new, dec=dec)
    return out


def port_run(cfg, params, tin, tok, pos, batch=None):
    logits, _, aux = TT.forward(params, cfg, tin)
    out = {"logits": logits, "aux": aux}
    if batch is not None:
        out["loss"] = TT.loss_fn(params, cfg, batch)
    if cfg.family != "encoder":
        caches, last = TT.prefill(params, cfg, tin, CACHE_LEN)
        new, dec = TT.decode_step(params, cfg, caches,
                                  torch.from_numpy(tok),
                                  torch.tensor(pos, dtype=torch.int32))
        out.update(caches=caches, last=last, new_caches=new, dec=dec)
    return out


def assert_caches(got, want, tol, what):
    """Cache trees of either package: the same leaves, ``kpos`` bit for
    bit, the rest within ``tol`` relative to each value and to the leaf's
    largest value (0: bit for bit)."""
    g, w = cache_leaves(got), cache_leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        if path[-1] == "kpos" or tol == 0:
            assert_bits(a.numpy() if isinstance(a, torch.Tensor)
                        and a.dtype != torch.bfloat16 else a,
                        np.asarray(b), f"{what} {path}")
        else:
            # caches hold activations, not logits: the absolute part of
            # the tolerance scales with the leaf's largest value
            assert tuple(a.shape) == tuple(np.shape(b)), (what, path)
            scale = max(1.0, float(np.abs(np32(b)).max()))
            np.testing.assert_allclose(np32(a), np32(b), rtol=tol,
                                       atol=tol * scale,
                                       err_msg=f"{what} {path}")
    assert rolling_flags(got) == rolling_flags(want), what


def rolling_flags(tree):
    if isinstance(tree, dict):
        return [f for k in sorted(tree) for f in rolling_flags(tree[k])]
    return [tree.rolling] if hasattr(tree, "rolling") else []


def check_bf16_against_reference(arch, monkeypatch, seed=4):
    """bf16 compute (the configs' default): the port's forward, prefill
    and decode logits against the reference's with every operation's
    bf16 result rounded (`op_by_op`; MoE configs' routing recorded there
    and replayed in the port and in the f32 run), held norm-wise by `assert_bf16_within_own_error` against
    the reference's f32 run on the same routing."""
    import dataclasses as dc
    cfg, jcfg = configs(arch, remat=False)
    assert cfg.compute_dtype == "bfloat16"
    params, jparams = params_pair(cfg, seed=seed)
    tin, jin, tok, pos = inputs_pair(cfg, B, S, seed=seed + 1)
    recorded = record_routing(monkeypatch)
    want = op_by_op(lambda p, i: reference_run(jcfg, p, i, tok, pos),
                    jparams, jin)
    jax.effects_barrier()
    assert bool(recorded) == bool(cfg.n_experts)
    f32 = dc.replace(jcfg, compute_dtype="float32")
    queue = force_routing(monkeypatch, recorded)
    want32 = jax.jit(lambda p, i: reference_run(f32, p, i, tok, pos))(
        jparams, jin)
    jax.effects_barrier()
    assert queue == []
    queue = replay_routing(monkeypatch, recorded)
    got = port_run(cfg, params, tin, tok, pos)
    assert queue == []
    assert got["logits"].dtype == torch.float32
    keys = ["logits"] if cfg.family == "encoder" else ["logits", "last",
                                                      "dec"]
    ratio = assert_bf16_within_own_error([got[k] for k in keys],
                                         [want[k] for k in keys],
                                         [want32[k] for k in keys], arch)
    if cfg.family != "encoder":
        for (path, a), (_, b) in zip(cache_leaves(got["new_caches"]),
                                     cache_leaves(want["new_caches"])):
            assert str(a.dtype) == f"torch.{b.dtype}", path
            if path[-1] == "kpos":
                assert_bits(a, b, str(path))
    return ratio
