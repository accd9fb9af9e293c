"""Measure, on the CPU, how far two bf16 runs of the language models lie
apart, and how the full-width yi-6b amplifies rounding; the numbers
behind the bf16 criterion of ``tests/test_torch_transformer.py`` and
behind step G3's conditioned consistency check in ``chip_smoke.py``.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_lm_bf16_probe.py parity
    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_lm_bf16_probe.py depth 2 8
    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_lm_bf16_probe.py conditioning ARCH ...
    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_lm_bf16_probe.py reference_spread [smoke]
    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_lm_bf16_probe.py grad_spread

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
``reference_spread``: step S4's size of ``chip_smoke.py`` (yi-6b's
widths, 2 layers, bf16, a batch of 8 x 256 tokens, S4's
sequence-parallel rules, the port's seed-0 parameters), the loss alone
in both packages: the port's on one rank and on a 2 x 2 gloo world, the
reference's on one device and on a 2 x 2 mesh of four forced host
devices (``tests/_jax_sharded.py``; jitted as usual, compiled without
excess precision, and in f32); each package's |sharded - one|, the
spread that S4's sharded loss at the reference's init is set beside.
The parameters take about 3.5 GB in f32 in each of the four ranks and
in the JAX process, one after the other; about 3 minutes.  With
``smoke``, yi-6b's smoke config on 8 x 64 tokens under S4's rules, S1's
and S4's without the sequence's sharding (seconds).  ``grad_spread``:
per config of ``tests/test_torch_seq_parallel.py``'s `SPREAD`, the
largest f32 gradient distance sharded against one rank (device) over
the leaf's largest element in each package at the reference's init, the
largest per-leaf ratio of the two, and the largest share of the test's
bound (about a minute).
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


S4_KEYS = ("heads", "kv_heads", "head_dim", "attn_seq", "seq")


def _rule_sets(cfg, smoke: bool) -> dict:
    """S4's rules (``chip_smoke._s_rule_sets``: the sequence-parallel
    entries ``arch_rules`` gives the 16-wide model axis for qwen3-14b's
    40 heads); at the smoke size also S1's and those of S4 without the
    sequence's sharding (the heads' dim over ``model`` alone)."""
    from repro_torch.configs import arch_rules
    base = arch_rules(cfg, "train_4k", model_axis=2, data_axis=2)
    sp16 = arch_rules(get_config("qwen3-14b"), "train_4k")
    sets = {"S4": dict(base, **{k: sp16[k] for k in S4_KEYS})}
    if smoke:
        sets["S1"] = base
        sets["S4 without seq"] = dict(base, heads=None, kv_heads=None,
                                      head_dim="model")
    return sets


def reference_spread(smoke: bool = False) -> None:
    import tempfile
    import time

    import _jax_sharded
    from _torch_world import World
    from repro_torch.data.pipeline import DataState, make_batch
    kw = {"n_layers": 2, "microbatches": 1}
    cfg = dataclasses.replace(get_config("yi-6b", smoke=smoke), **kw)
    b, s = (8, 64) if smoke else (8, 256)
    sets = _rule_sets(cfg, smoke)
    batch = make_batch(cfg, b, s, DataState(0, 0), device="cpu")
    print(f"{cfg.name}, 2 layers, bf16, batch {b} x {s}, the port's seed-0 "
          f"parameters; |sharded - one| of the loss on 2 x 2 meshes",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        world = World(4, tmp)
        try:
            port = {n: world.run("sharded_loss", "yi-6b", kw, r, b, s,
                                 smoke, deadline=3000)[0]
                    for n, r in sets.items()}
        finally:
            world.close()
        print(f"the port's worlds: {time.perf_counter() - t0:.1f} s",
              flush=True)
        t1 = time.perf_counter()
        cases, arrays = [], {}
        for n, r in sets.items():
            for tag, extra in (("jit", {}), ("op", {"op_by_op": True}),
                               ("f32", {"kw": dict(kw,
                                                   compute_dtype="float32")})):
                cid = f"{n}:{tag}"
                cases.append(dict({"id": cid, "arch": "yi-6b",
                                   "smoke": smoke, "kw": kw, "kind": "loss",
                                   "rules": r, "seed_params": True},
                                  **extra))
                arrays.update({f"{cid}/in/{k}": v.numpy()
                               for k, v in batch.items()})
        ref = _jax_sharded.Run(cases, arrays, tmp, timeout=3000).results()
        print(f"the reference: {time.perf_counter() - t1:.1f} s", flush=True)
    for n, r in sets.items():
        one, two, f32 = port[n]
        print(f"{n} {({k: r[k] for k in S4_KEYS})}: the port one rank "
              f"{one:.7f}, sharded {two:.7f}, |diff| {abs(two - one):.3g} "
              f"(bf16's own error, against f32 compute: "
              f"{abs(one - f32):.3g})", flush=True)
        for tag, name in (("jit", "bf16 jitted"), ("op", "bf16 op by op"),
                          ("f32", "f32")):
            j1 = float(ref[f"{n}:{tag}/loss1"])
            j2 = float(ref[f"{n}:{tag}/loss2"])
            print(f"  the reference, {name}: one device {j1:.7f}, sharded "
                  f"{j2:.7f}, |diff| {abs(j2 - j1):.3g}", flush=True)


def grad_spread() -> None:
    """The numbers behind ``test_sharded_gradients_within_reference_spread``
    (``tests/test_torch_seq_parallel.py``), printed per config."""
    import tempfile

    import _jax_sharded
    import test_torch_seq_parallel as M
    from _torch_world import World
    from repro_torch.data.pipeline import DataState, make_batch
    with tempfile.TemporaryDirectory() as tmp:
        cases, arrays = [], {}
        for arch, kw in M.SPREAD:
            cid = M._spread_id(arch, kw)
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      **M._spread_kw(arch, kw))
            batch = make_batch(cfg, 8, 64, DataState(0, 0), device="cpu")
            arrays.update(_jax_sharded.case_arrays(
                cid, cfg, {k: v.numpy() for k, v in batch.items()}))
            cases.append({"id": cid, "arch": arch,
                          "kw": M._spread_kw(arch, kw), "kind": "grads"})
        run = _jax_sharded.Run(cases, arrays, tmp)
        world = World(4, tmp)
        try:
            ports = {M._spread_id(a, kw): world.run(
                "sharded_gradients", a, 2, 2, M._spread_kw(a, kw), False,
                deadline=240)[0] for a, kw in M.SPREAD}
        finally:
            world.close()
        ref = run.results()
    print("| Config | port | reference | ratio | share of bound |")
    for cid, (_, _, grads) in ports.items():
        rows = []
        for k, (one, two) in grads.items():
            g1, g2 = ref[f"{cid}/g1{k}"], ref[f"{cid}/g2{k}"]
            p = float(np.abs(two - one).max() / np.abs(one).max())
            r = float(np.abs(g2 - g1).max() / np.abs(g1).max())
            rows.append((p, r))
        print(f"| {cid} | {max(p for p, _ in rows):.3g} | "
              f"{max(r for _, r in rows):.3g} | "
              f"{max(p / r for p, r in rows if r > 0):.3g} | "
              f"{max(p / max(2 * r, 1e-4) for p, r in rows):.3g} |",
              flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "grad_spread":
        grad_spread()
    elif sys.argv[1] == "reference_spread":
        reference_spread(smoke=sys.argv[2:] == ["smoke"])
    elif sys.argv[1] == "parity":
        parity()
    elif sys.argv[1] == "conditioning":
        conditioning(sys.argv[2:])
    else:
        depth([int(a) for a in sys.argv[2:]])
