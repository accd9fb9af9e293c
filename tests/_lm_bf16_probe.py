"""Measure, on the CPU, how far two bf16 runs of the language models lie
apart, and how the full-width yi-6b amplifies rounding; the numbers
behind the bf16 criterion of ``tests/test_torch_transformer.py`` and
behind step G3's conditioned consistency check in ``chip_smoke.py``.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_lm_bf16_probe.py parity
    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_lm_bf16_probe.py depth 2 8
    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_lm_bf16_probe.py conditioning ARCH ...

``parity``: for each smoke config and seeds 0-5, the forward logits in
bf16 compute of the port (the reference's routing replayed), of the
reference compiled without excess precision (its op-by-op bits) and of
the reference jitted as usual, and of the reference in f32 on the same
routing: the port's largest elementwise distance from the op-by-op
reference and the share of elements within 3e-2, the reference's own
jitted-against-op-by-op distance, and |port - ref| / |ref bf16 - ref
f32|.  ``depth L ...``: yi-6b at full width with L layers in f32 on the
CPU (about 1 GB per layer): decode against the full forward, with the
seeded init and with q and k rescaled to fan-in d_model, and how a 1e-7
relative perturbation of the embeddings grows layer by layer.
``conditioning ARCH ...``: for each smoke config in f32 (the MoE ones
at a capacity that drops no token), with the reference's init and with
q and k rescaled to fan-in: how far a 1e-7 relative perturbation of the
parameters moves the one-rank gradients (the largest change over a
leaf's largest element), and how far the sharded gradients on a 2 x 2
gloo world lie from the one-rank ones; the numbers behind
``tests/test_torch_seq_parallel.py``'s per-family check.
"""

import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_models import (configs, force_routing, inputs_pair, op_by_op,
                           params_pair, record_routing, replay_routing)
from repro.configs import ARCH_NAMES
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import transformer as TT
from repro_torch.models.common import init_params


def parity(seeds=range(6)) -> None:
    mp = pytest.MonkeyPatch()
    for arch in ARCH_NAMES:
        rows = []
        for seed in seeds:
            cfg, jcfg = configs(arch, remat=False)
            params, jparams = params_pair(cfg, seed=seed)
            tin, jin, _, _ = inputs_pair(cfg, 2, 20, seed=seed + 1)
            routes = record_routing(mp)
            want = op_by_op(lambda p, i: JT.forward(p, jcfg, i)[0],
                            jparams, jin)
            jax.effects_barrier()
            recorded = [np.asarray(r) for r in routes]
            mp.undo()
            force_routing(mp, recorded)
            jitted = jax.jit(lambda p, i: JT.forward(p, jcfg, i)[0])(
                jparams, jin)
            jax.effects_barrier()
            force_routing(mp, recorded)
            f32 = dataclasses.replace(jcfg, compute_dtype="float32")
            want32 = jax.jit(lambda p, i: JT.forward(p, f32, i)[0])(
                jparams, jin)
            jax.effects_barrier()
            mp.undo()
            replay_routing(mp, recorded)
            got = TT.forward(params, cfg, tin)[0].numpy()
            mp.undo()
            w, j, f = (np.asarray(a, np.float32)
                       for a in (want, jitted, want32))
            err = np.abs(got - w)
            rows.append((float(err.max()),
                         float((err <= 3e-2 + 3e-2 * np.abs(w)).mean()),
                         float(np.abs(j - w).max()),
                         float(np.linalg.norm(got - w)
                               / np.linalg.norm(w - f))))
        print(f"{arch}: port against op-by-op max "
              f"{max(r[0] for r in rows):.4g}, share within 3e-2 min "
              f"{min(r[1] for r in rows):.4f}; reference jitted against "
              f"op-by-op max {max(r[2] for r in rows):.4g}; |port - ref| / "
              f"|ref bf16 - ref f32| max {max(r[3] for r in rows):.3f}",
              flush=True)


def depth(layers) -> None:
    for n in layers:
        cfg = dataclasses.replace(get_config("yi-6b"), n_layers=n,
                                  compute_dtype="float32")
        params = init_params(TT.lm_plan(cfg), seed=0, device="cpu")
        g = torch.Generator().manual_seed(9)
        toks = torch.randint(0, cfg.vocab, (2, 25), generator=g,
                             dtype=torch.int32)
        errs = []
        for conditioned in (False, True):
            if conditioned:
                for name in ("wq", "wk"):
                    w = params["blocks"]["attn"][name]
                    w.mul_((w.shape[-2] / w.shape[-3]) ** 0.5)
            full = TT.forward(params, cfg, {"tokens": toks})[0]
            caches, _ = TT.prefill(params, cfg, {"tokens": toks[:, :24]},
                                   64)
            _, dec = TT.decode_step(params, cfg, caches, toks[:, 24:], 24)
            errs.append(float((dec - full[:, -1]).abs().max()))
            if conditioned:
                break
            x0 = TT._embed_inputs(params, cfg, {"tokens": toks})
            x1 = x0 * (1 + 1e-7 * torch.randn(x0.shape, generator=g))
            rope = TT._rope(cfg, "cpu")
            growth = []
            for i in range(n):
                p = TT._layer(params["blocks"], i)
                x0, x1 = (TT._attn_block(p, x, cfg, kind="causal",
                                         use_rope=True, rope_freqs=rope)[0]
                          for x in (x0, x1))
                growth.append(float(((x0 - x1).norm(dim=-1)
                                     / x0.norm(dim=-1)).max()))
        print(f"yi-6b width, {n} layers, f32: decode against forward "
              f"{errs[0]:.3g} (seeded init), {errs[1]:.3g} (q, k at fan-in "
              f"d_model); a 1e-7 perturbation after each layer "
              f"{[float(f'{x:.3g}') for x in growth]}", flush=True)
        del params


def _flat_grads(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_grads(tree[k], f"{prefix}/{k}"))
        return out
    return {} if tree is None else {prefix: tree}


def conditioning(archs) -> None:
    import tempfile

    from _torch_world import World, condition_attention
    from repro_torch.data.pipeline import DataState, make_batch
    from repro_torch.train.step import loss_and_grads
    with tempfile.TemporaryDirectory() as tmp:
        world = World(4, tmp)
        try:
            for arch in archs:
                base = get_config(arch, smoke=True)
                kw = {"compute_dtype": "float32"}
                if base.n_experts:
                    kw["capacity_factor"] = float(base.n_experts)
                cfg = dataclasses.replace(base, **kw)
                batch = make_batch(cfg, 8, 64, DataState(0, 0), device="cpu")
                for conditioned in (False, True):
                    params = init_params(TT.lm_plan(cfg), seed=0,
                                         device="cpu")
                    if conditioned:
                        condition_attention(params)
                    grads = _flat_grads(loss_and_grads(params, cfg,
                                                       batch)[2])
                    g = torch.Generator().manual_seed(1)
                    moved = _flat_grads(loss_and_grads(TT.tree_map(
                        lambda x: x * (1 + 1e-7 * torch.randn(
                            x.shape, generator=g)), params), cfg, batch)[2])
                    sens = max(float((moved[k] - v).abs().max()
                                     / v.abs().max()) for k, v in
                               grads.items())
                    _, _, pairs = world.run("sharded_gradients", arch, 2, 2,
                                            kw, conditioned,
                                            deadline=240)[0]
                    off = max(float(np.abs(b - a).max() / np.abs(a).max())
                              for a, b in pairs.values())
                    init = ("q, k at fan-in" if conditioned
                            else "reference init")
                    print(f"{arch} smoke f32, {init}: a 1e-7 perturbation "
                          f"moves the gradients by {sens:.3g} of a leaf's "
                          f"largest element; sharded (2 x 2) against one "
                          f"rank {off:.3g}", flush=True)
        finally:
            world.close()


if __name__ == "__main__":
    if sys.argv[1] == "parity":
        parity()
    elif sys.argv[1] == "conditioning":
        conditioning(sys.argv[2:])
    else:
        depth([int(a) for a in sys.argv[2:]])
