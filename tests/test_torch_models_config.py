"""The port's model configs (`repro_torch.models.config`,
`repro_torch.configs`) and parameter plans against the reference's,
exactly: no tolerance anywhere in this file.

* ``ModelConfig`` field for field and every derived count, for the ten
  architectures, full and smoke (20 configs), and its conversion from
  the reference's (`repro_torch.convert.model_config_from_reference`);
* ``SHAPES``, ``skip_reason``, ``applicable_shapes`` and ``arch_rules``
  for every (arch, shape), single- and multi-pod;
* ``lm_plan``'s tree for all 20 configs: key paths (JAX's flatten
  order), shapes, logical axes, init kind and dtype name;
* the structure of ``init_caches`` and ``cache_axes``;
* ``init_params``: each init kind's values, and seeds that do not depend
  on the process (the reference's salted ``hash`` does).
"""

import _torch_threads  # noqa: F401  (one torch thread)
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import (ARCH_NAMES, SHAPES, applicable_shapes,
                           arch_rules, get_config, skip_reason)
from repro.models import common as jcommon
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as TT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [(a, smoke) for a in ARCH_NAMES for smoke in (False, True)]
IDS = [f"{a}{'-smoke' if s else ''}" for a, s in CONFIGS]


def _derived(cfg):
    return (cfg.head_dim_eff, cfg.vocab_padded, cfg.d_inner,
            cfg.n_attn_apps, cfg.sub_pattern(), cfg.param_count(),
            cfg.active_param_count())


@pytest.mark.parametrize("arch,smoke", CONFIGS, ids=IDS)
def test_config_field_for_field(arch, smoke):
    got, want = tconfigs.get_config(arch, smoke), get_config(arch, smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert _derived(got) == _derived(want)
    conv = convert.model_config_from_reference(dataclasses.asdict(want))
    assert conv == got


def test_registry_and_unknown_names():
    assert tconfigs.ARCH_NAMES == ARCH_NAMES
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-2")
    with pytest.raises(ValueError, match="unknown ModelConfig fields"):
        convert.model_config_from_reference({"name": "x", "experts": 2})


def test_shapes_and_skips():
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in SHAPES.items()}
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            assert tconfigs.skip_reason(tconfigs.get_config(arch), shape) \
                == skip_reason(get_config(arch), shape)
        assert tconfigs.applicable_shapes(tconfigs.get_config(arch)) \
            == applicable_shapes(get_config(arch))
    # tests/test_models_smoke.py::test_shape_skips_documented on the port
    total = sum(len(tconfigs.applicable_shapes(tconfigs.get_config(a)))
                for a in ARCH_NAMES)
    assert total == 33


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_arch_rules(arch):
    for shape in SHAPES:
        for multi_pod in (False, True):
            assert tconfigs.arch_rules(tconfigs.get_config(arch), shape,
                                       multi_pod=multi_pod) \
                == arch_rules(get_config(arch), shape, multi_pod=multi_pod)
    assert tcommon.DEFAULT_RULES == jcommon.DEFAULT_RULES


def _reference_plan(cfg):
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        JT.lm_plan(cfg), is_leaf=lambda x: isinstance(x, jcommon.PSpec))
    return [(tuple(k.key for k in path), spec) for path, spec in leaves]


@pytest.mark.parametrize("arch,smoke", CONFIGS, ids=IDS)
def test_lm_plan_tree(arch, smoke):
    got = tcommon.plan_leaves(TT.lm_plan(tconfigs.get_config(arch, smoke)))
    want = _reference_plan(get_config(arch, smoke))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert (a.shape, a.axes, a.init) == (b.shape, b.axes, b.init), path
        assert _dtype_name(a.dtype) == _dtype_name(b.dtype), path


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _leaf_triples(tree):
    """[(path, (shape, dtype name, axes))] of a cache_axes tree."""
    out = []
    for k in sorted(tree):
        node = tree[k]
        fields = (("k", "v", "kpos") if hasattr(node, "kpos")
                  else ("h", "conv_x", "conv_B", "conv_C"))
        for f in fields:
            shape, dtype, axes = getattr(node, f)
            out.append(((k, f), (tuple(shape), _dtype_name(dtype),
                                 tuple(axes))))
    return out


@pytest.mark.parametrize("arch", [a for a in ARCH_NAMES
                                  if get_config(a).family != "encoder"])
def test_cache_structure(arch):
    for smoke, cache_len in ((True, 48), (True, 8), (False, 32768)):
        tcfg, jcfg = tconfigs.get_config(arch, smoke), get_config(arch,
                                                                   smoke)
        got = TT.cache_axes(tcfg, 3, cache_len)
        want = JT.cache_axes(jcfg, 3, cache_len)
        assert _leaf_triples(got) == _leaf_triples(want)
        flags = [getattr(got[k], "rolling", None) for k in sorted(got)]
        assert flags == [getattr(want[k], "rolling", None)
                         for k in sorted(want)]
    caches = TT.init_caches(tconfigs.get_config(arch, True), 2, 16,
                            device="cpu")
    for k, node in caches.items():
        for leaf in (node.k, node.v) if hasattr(node, "kpos") else node:
            assert leaf.device.type == "cpu" and not bool(leaf.any())


def test_init_params_kinds():
    cfg = tconfigs.get_config("yi-6b", smoke=True)
    plan = TT.lm_plan(cfg)
    params = tcommon.init_params(plan, seed=0, device="cpu")
    for path, spec in tcommon.plan_leaves(plan):
        leaf = params
        for k in path:
            leaf = leaf[k]
        assert tuple(leaf.shape) == spec.shape and leaf.dtype == torch.float32
        if spec.init == "zeros":
            assert not bool(leaf.any())
        elif spec.init == "ones":
            assert bool((leaf == 1).all())
        else:
            fan = spec.shape[-2] if spec.init == "scaled" else None
            std = 0.02 if spec.init == "normal" else fan ** -0.5
            assert abs(float(leaf.std()) / std - 1) < 0.1, path
    again = tcommon.init_params(plan, seed=0, device="cpu")
    other = tcommon.init_params(plan, seed=1, device="cpu")
    half = tcommon.init_params(plan, seed=0, device="cpu",
                               dtype=torch.bfloat16)
    for path, _ in tcommon.plan_leaves(plan):
        a, b, c, h = params, again, other, half
        for k in path:
            a, b, c, h = a[k], b[k], c[k], h[k]
        assert torch.equal(a, b) and h.dtype == torch.bfloat16
        assert torch.equal(a.to(torch.bfloat16), h)
        if bool(a.any()) and not bool((a == 1).all()):
            assert not torch.equal(a, c), path
    gen = torch.Generator().manual_seed(0)
    via_gen = tcommon.init_params(plan, generator=gen, device="cpu")
    assert torch.equal(via_gen["embed"], params["embed"])


def test_init_params_are_the_same_in_every_process():
    """Per-leaf seeds come from the CRC-32 of the path, not Python's
    salted ``hash``: two processes with different hash seeds draw the
    same parameters."""
    code = ("import torch; from repro_torch.configs import get_config; "
            "from repro_torch.models import transformer as T; "
            "from repro_torch.models.common import init_params; "
            "p = init_params(T.lm_plan(get_config('zamba2-1.2b', True)), "
            "seed=3, device='cpu'); "
            "print(float(p['blocks']['mamba']['wx'].sum()), "
            "float(p['shared_attn']['attn']['wq'].sum()))")
    outs = set()
    for salt in ("1", "2"):
        env = {**os.environ, "PYTHONHASHSEED": salt,
               "PYTHONPATH": os.path.join(ROOT, "src")}
        run = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=60)
        assert run.returncode == 0, run.stderr
        outs.add(run.stdout)
    assert len(outs) == 1


def test_sharder():
    """Disabled, the identity; enabled (the default), it redistributes a
    DTensor to the rule's placements and refuses a plain tensor."""
    from repro_torch.launch.mesh import (DTensor, Replicate, Shard,
                                         make_local_mesh)
    sh = tcommon.Sharder(enabled=False)
    x = torch.ones(2)
    assert sh(x, "batch") is x and not sh.enabled
    mesh = make_local_mesh(1, 1, device="cpu")
    on = tcommon.Sharder({"batch": ("data",), "mlp": "model"}, mesh=mesh)
    assert on.enabled
    with pytest.raises(TypeError, match="plain"):
        on(torch.ones(2, 4), "batch", "mlp")
    y = on(on.place(torch.ones(2, 4), None, None), "batch", "mlp")
    assert isinstance(y, DTensor)
    assert y.placements == (Shard(0), Shard(1))
    assert on(y, None, None).placements == (Replicate(), Replicate())
