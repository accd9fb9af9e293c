"""Measure, on the CPU, how far two bf16 runs of the language models lie
apart, and how the full-width yi-6b amplifies rounding; the numbers
behind the bf16 criterion of ``tests/test_torch_transformer.py`` and
behind step G3's conditioned consistency check in ``chip_smoke.py``.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_lm_bf16_probe.py parity
    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/_lm_bf16_probe.py depth 2 8

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


if __name__ == "__main__":
    if sys.argv[1] == "parity":
        parity()
    else:
        depth([int(a) for a in sys.argv[2:]])
