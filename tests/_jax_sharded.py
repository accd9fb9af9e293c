"""The JAX package's language models, sharded on a 2 x 2 (data, model)
mesh of four forced host devices and on one device, for the port's
parity tests (``tests/test_torch_sharded_inference.py``,
``tests/test_torch_seq_parallel.py``).

`Run(cases, arrays, tmpdir)` runs every case in one subprocess (JAX
fixes its device count at its first use, so the forced devices need a
process of their own) and returns at once; its `results` wait and give
``{name: numpy array}``.  The cases are dicts:

* ``{"id", "arch", "kw", "kind": "prefill", "cache_len"}``: the sharded
  prefill under the ``prefill_32k`` rules (an encoder's whole forward
  in its place, as ``repro.launch.dryrun`` lowers it): ``id/last`` and
  ``id/cache/<leaf>``.
* ``{..., "kind": "decode", "shape", "cache_len", "steps"}``: the
  one-device prefill, then ``steps`` greedy one-device decode steps
  (``id/tokens``, (steps, B)), and the same tokens decoded under the
  rules of ``shape`` from the prefill's caches placed by
  ``repro.launch.specs.cache_specs``' shardings: ``id/logits`` (steps,
  B, V) and ``id/cache/<leaf>``.
* ``{..., "kind": "grads"}``: ``jax.value_and_grad(loss_fn)`` in f32 on
  one device and sharded under the ``train_4k`` rules: ``id/loss1``,
  ``id/loss2``, ``id/g1/<leaf>``, ``id/g2/<leaf>``.
* ``{..., "kind": "loss"}``: the loss alone, likewise: ``id/loss1``,
  ``id/loss2``.

A case may also say ``"smoke": false`` (the config's published
widths), ``"rules"`` (entries that replace ``arch_rules``') and
``"seed_params": true`` (the subprocess makes the port's seed-0
parameters itself, for a case too large to pass through a file); a
loss case ``"op_by_op": true`` (compiled without excess precision: each
bf16 result rounded, as when the reference runs op by op).
``arrays`` holds each case's parameters (``id/p/<leaf path>``, the
port's ``init_params`` as numpy, so both packages start from the same
values) and its inputs (``id/in/<name>``), as `case_arrays` makes
them.  Leaf paths are ``/``-joined keys, as the port's tests flatten
their trees.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 600


def flatten(tree, prefix="") -> dict:
    """``{"/a/b": leaf}`` of a nest of dicts."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


class Run:
    """The subprocess on ``cases``, started at once; `results` waits for
    it (once) and `close` stops it if it still runs."""

    def __init__(self, cases: list, arrays: dict, tmpdir,
                 timeout: float = TIMEOUT_S):
        self.timeout = timeout
        src = os.path.join(str(tmpdir), "in.npz")
        self.dst = os.path.join(str(tmpdir), "out.npz")
        np.savez(src, __cases__=json.dumps(cases), **arrays)
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), src, self.dst],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        self.out = None

    def results(self) -> dict:
        if self.out is None:
            try:
                out, err = self.proc.communicate(timeout=self.timeout)
            except subprocess.TimeoutExpired:
                self.close()
                raise
            assert self.proc.returncode == 0 and "OK" in out, err[-4000:]
            self.out = dict(np.load(self.dst))
        return self.out

    def __getitem__(self, key):
        return self.results()[key]

    def cache(self, cid) -> dict:
        """A decode or prefill case's cache leaves, by path."""
        pre = f"{cid}/cache"
        return {k[len(pre):]: v for k, v in self.results().items()
                if k.startswith(pre + "/")}

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.communicate()


def case_arrays(cid: str, cfg, inputs: dict) -> dict:
    """A case's arrays: the port's seed-0 parameters of ``cfg`` and the
    numpy ``inputs``."""
    from repro_torch import convert
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params
    host = convert.params_to_numpy(init_params(T.lm_plan(cfg), seed=0,
                                               device="cpu"))
    out = {f"{cid}/p{k}": v for k, v in flatten(host).items()}
    out.update({f"{cid}/in/{k}": v for k, v in inputs.items()})
    return out


# --------------------------------------------------------------------------
# the subprocess
# --------------------------------------------------------------------------

def _cache_flat(tree, prefix=""):
    from repro.models.attention import KVCache
    if isinstance(tree, KVCache):
        tree = {"k": tree.k, "v": tree.v, "kpos": tree.kpos}
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_cache_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.strip("/").split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def _run_case(case, inp, out):
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.compat import set_mesh
    from repro.configs import arch_rules, get_config
    from repro.launch.mesh import make_local_mesh
    from repro.launch.specs import cache_specs
    from repro.models import transformer as T
    from repro.models.common import Sharder, abstract_params

    cid, kind = case["id"], case["kind"]
    cfg = dataclasses.replace(get_config(case["arch"],
                                         smoke=case.get("smoke", True)),
                              **case["kw"])
    if case.get("seed_params"):
        params = _seed_params(case)
    else:
        params = _unflatten({k[len(cid) + 2:]: jnp.asarray(v)
                             for k, v in inp.items()
                             if k.startswith(cid + "/p/")})
    host = {k[len(cid) + 4:]: v for k, v in inp.items()
            if k.startswith(cid + "/in/")}
    mesh = make_local_mesh(2, 2)
    shape = {"prefill": "prefill_32k", "grads": "train_4k",
             "loss": "train_4k"}.get(kind, case.get("shape"))
    rules = arch_rules(cfg, shape, model_axis=2, data_axis=2)
    rules.update({k: tuple(v) if isinstance(v, list) else v
                  for k, v in case.get("rules", {}).items()})
    sharder = Sharder(rules, enabled=True)

    def on_mesh(tree):
        specs = abstract_params(T.lm_plan(cfg), mesh, rules)
        return jax.tree.map(lambda x, s: jax.device_put(x, s.sharding),
                            tree, specs)

    def batch_on_mesh(batch):
        return {k: jax.device_put(v, NamedSharding(
            mesh, P(rules.get("batch"), *(None,) * (v.ndim - 1))))
            for k, v in batch.items()}

    if kind == "prefill":
        with set_mesh(mesh):
            if cfg.family == "encoder":
                fn = jax.jit(lambda p, b: T.forward(p, cfg, b,
                                                    sharder=sharder)[0])
                last, caches = fn(on_mesh(params), batch_on_mesh(host)), {}
            else:
                fn = jax.jit(lambda p, b: T.prefill(
                    p, cfg, b, case["cache_len"], sharder=sharder))
                caches, last = fn(on_mesh(params), batch_on_mesh(host))
        out[f"{cid}/last"] = np.asarray(last)
        for k, v in _cache_flat(caches).items():
            out[f"{cid}/cache{k}"] = v
    elif kind == "decode":
        batch = {k: jnp.asarray(v) for k, v in host.items()}
        pos0 = host["tokens"].shape[1] + (
            cfg.prefix_len if cfg.family == "vlm" else 0)
        caches, last = jax.jit(lambda p, b: T.prefill(
            p, cfg, b, case["cache_len"]))(params, batch)
        one = jax.jit(lambda p, c, t, q: T.decode_step(p, cfg, c, t, q))
        tok, c, fed = jnp.argmax(last, -1).astype(jnp.int32)[:, None], \
            caches, []
        for i in range(case["steps"]):
            fed.append(np.asarray(tok[:, 0]))
            c, logits = one(params, c, tok, jnp.int32(pos0 + i))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        specs = cache_specs(cfg, shape, mesh, rules)
        with set_mesh(mesh):
            c = jax.tree.map(lambda x, s: jax.device_put(x, s.sharding),
                             caches, specs)
            step = jax.jit(lambda p, c, t, q: T.decode_step(
                p, cfg, c, t, q, sharder=sharder), donate_argnums=(1,))
            sp = on_mesh(params)
            got = []
            for i, t in enumerate(fed):
                tok = jax.device_put(t[:, None].astype(np.int32),
                                     NamedSharding(mesh,
                                                   P(rules.get("batch"))))
                q = jax.device_put(np.int32(pos0 + i),
                                   NamedSharding(mesh, P()))
                c, logits = step(sp, c, tok, q)
                got.append(np.asarray(logits))
        out[f"{cid}/tokens"] = np.stack(fed)
        out[f"{cid}/logits"] = np.stack(got)
        for k, v in _cache_flat(c).items():
            out[f"{cid}/cache{k}"] = v
    elif kind == "grads":
        batch = {k: jnp.asarray(v) for k, v in host.items()}

        def loss(p, b, sh=None):
            return T.loss_fn(p, cfg, b, sharder=sh)[0]

        l1, g1 = jax.jit(jax.value_and_grad(loss))(params, batch)
        with set_mesh(mesh):
            l2, g2 = jax.jit(jax.value_and_grad(
                lambda p, b: loss(p, b, sharder)))(on_mesh(params),
                                                   batch_on_mesh(host))
        out[f"{cid}/loss1"] = np.asarray(l1)
        out[f"{cid}/loss2"] = np.asarray(l2)
        for tag, g in (("g1", g1), ("g2", g2)):
            for k, v in flatten(g).items():
                out[f"{cid}/{tag}{k}"] = np.asarray(v, np.float32)
    elif kind == "loss":
        batch = {k: jnp.asarray(v) for k, v in host.items()}
        # op by op: every bf16 result rounded, as torch rounds it
        opts = ({"xla_allow_excess_precision": False}
                if case.get("op_by_op") else None)
        out[f"{cid}/loss1"] = np.asarray(jax.jit(
            lambda p, b: T.loss_fn(p, cfg, b)[0], compiler_options=opts)(
                params, batch))
        with set_mesh(mesh):
            out[f"{cid}/loss2"] = np.asarray(jax.jit(
                lambda p, b: T.loss_fn(p, cfg, b, sharder=sharder)[0],
                compiler_options=opts)(on_mesh(params), batch_on_mesh(host)))
    else:
        raise ValueError(kind)
    jax.clear_caches()


def _seed_params(case):
    """The port's seed-0 parameters of the case's config, made here (a
    case too large to pass through a file; the same values in every
    process) and handed to JAX."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.common import init_params
    cfg = dataclasses.replace(get_config(case["arch"],
                                         smoke=case.get("smoke", True)),
                              **case["kw"])
    params = init_params(T.lm_plan(cfg), seed=0, device="cpu")
    return jax.tree.map(jnp.asarray, convert.params_to_numpy(params))


def main(src, dst):
    import jax
    assert len(jax.devices()) == 4
    inp = dict(np.load(src))
    cases = json.loads(str(inp.pop("__cases__")))
    out: dict = {}
    for case in cases:
        _run_case(case, inp, out)
    np.savez(dst, **out)
    print("OK")


if __name__ == "__main__":
    main(*sys.argv[1:3])
