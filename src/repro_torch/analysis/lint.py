"""skylint for the port: the AST layer of the static verifier.

Counterpart of ``repro.analysis.lint``.  Pure-`ast` analysis over
``src/repro_torch``: it imports neither torch nor jax and never the code
under inspection, so it runs in milliseconds on any host.

Pipeline:

1. collect every module's functions, their *loaded names* (an
   over-approximate callee set: bare `Name` loads plus `Attribute`
   tails), per-line suppressions, and the names that refer to torch;
2. build the repo-wide bare-name call graph and mark everything
   reachable from the pipeline roots (`rules.PIPELINE_ROOTS`, the
   functions the reference jits), stopping at the kernels' plain
   versions (`rules.PLAIN_VERSIONS`);
3. run rules R1-R6 (`repro_torch.analysis.rules`) over their scopes.

The bare-name reachability is deliberately an over-approximation (a
loaded name reaches EVERY function of that name anywhere in the tree):
a false edge at worst surfaces a finding that a human then suppresses
with a recorded justification; a missed edge would silently wave a host
sync through.

Which values are on the card is decided by following bindings, as the
reference's ``_device_producing`` does: a value is a tensor when it is
made by a call rooted at torch (other than the calls that return host
objects: ``torch.device``, ``torch.Generator``, ``torch.cuda.*``...), by
a ``*_fn`` factory's program, by a tensor method on such a value, or
through a local name bound to one.  Shapes, dtypes and devices are host
values.  A name is never matched on its own, so numpy data on the
serving paths (``s._head.tolist()``, ``bool(np.any(...))``) stays clean.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import (COMPAT_MODULE, HOT_PATHS,
                                        KERNEL_INTERNALS, KERNEL_SUBMODULES,
                                        PIPELINE_ROOTS, PLAIN_VERSIONS,
                                        R2_SCOPES, R6_SCOPES, RULES,
                                        STATE_OPERANDS)

__all__ = ["lint_paths", "collect_module", "ModuleInfo", "FunctionInfo"]

_SUPPRESS_RE = re.compile(r"#\s*skylint:\s*disable=([A-Za-z0-9,\s]+)")

# R1: methods that read the card on any receiver (numpy has none of them
# but item, which the serving paths never call on numpy data), and
# methods that do so on a tensor only (numpy arrays have them too)
_SYNC_METHODS = {"item", "cpu", "numpy", "synchronize"}
_TENSOR_SYNC_METHODS = {"tolist"}
_NP_FUNCS = {"numpy.asarray", "numpy.array"}
_CASTS = {"int", "float", "bool"}

# torch calls that return host objects, not tensors
_HOST_TORCH_CALLS = {
    "torch.device", "torch.Generator", "torch.finfo", "torch.iinfo",
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.numel", "torch.Size", "torch.dtype", "torch.get_default_dtype",
    "torch.no_grad", "torch.inference_mode", "torch.manual_seed",
}
_HOST_TORCH_PREFIXES = ("torch.cuda.", "torch.utils.", "torch.backends.",
                        "torch.distributed.", "torch.testing.",
                        "torch._C.", "torch.profiler.")
# tensor methods and attributes that read metadata, not device data
_META_METHODS = {"size", "dim", "ndimension", "numel", "nelement", "stride",
                 "storage_offset", "is_contiguous", "is_floating_point",
                 "is_complex", "element_size", "data_ptr",
                 "untyped_storage", "get_device", "is_pinned", "is_shared",
                 "tolist", "item", "numpy", "type"}
_META_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "requires_grad", "itemsize", "nbytes", "names", "is_sparse",
               "type"}


# --------------------------------------------------------------------------
# collection
# --------------------------------------------------------------------------

@dataclasses.dataclass
class FunctionInfo:
    qualname: str          # e.g. "SkylineStream.feed"
    name: str              # bare name, the call-graph key
    node: ast.AST
    module: "ModuleInfo"
    names: set[str]        # Name loads in the body
    attrs: set[str]        # Attribute tails in the body
    method: bool           # defined in a class body: reached by attribute


@dataclasses.dataclass
class ModuleInfo:
    path: str              # repo-relative path (finding location)
    modname: str           # dotted name ("repro_torch.serve.engine")
    tree: ast.Module
    lines: list[str]
    suppressions: dict[int, set[str]]   # 1-based line -> rule ids
    # local name -> the dotted module or object it imports
    imports: dict[str, str] = dataclasses.field(default_factory=dict)
    functions: list[FunctionInfo] = dataclasses.field(default_factory=list)


def _dotted(node) -> str | None:
    """'torch.cuda.synchronize' for a Name/Attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _loaded_names(node) -> tuple[set[str], set[str]]:
    """(bare Name loads, Attribute tails) in the subtree."""
    names, attrs = set(), set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            names.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            attrs.add(sub.attr)
    return names, attrs


def _suppressions(lines: list[str]) -> dict[int, set[str]]:
    """Per-line suppressed rules; a comment-only suppression line also
    covers the line below it."""
    out: dict[int, set[str]] = {}
    for i, text in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = {r.strip().upper() for r in m.group(1).split(",")
                 if r.strip()}
        out.setdefault(i, set()).update(rules)
        if text.lstrip().startswith("#"):  # comment-only: covers below
            out.setdefault(i + 1, set()).update(rules)
    return out


def _imports(tree: ast.Module) -> dict[str, str]:
    """Local name -> the full dotted name it was imported as
    (``import numpy as np`` gives np -> numpy; ``from torch.nn import
    functional as F`` gives F -> torch.nn.functional)."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    top = a.name.split(".")[0]
                    out.setdefault(top, top)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


class _FnCollector(ast.NodeVisitor):
    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.stack: list[tuple[str, bool]] = []   # (name, is a class)

    def _visit_fn(self, node):
        qual = ".".join([n for n, _ in self.stack] + [node.name])
        method = bool(self.stack) and self.stack[-1][1]
        self.mod.functions.append(
            FunctionInfo(qual, node.name, node, self.mod,
                         *_loaded_names(node), method))
        self.stack.append((node.name, False))
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_ClassDef(self, node):
        self.stack.append((node.name, True))
        self.generic_visit(node)
        self.stack.pop()


def _modname(path: str, repo_root: str) -> str:
    rel = os.path.relpath(path, repo_root)
    parts = rel.replace(os.sep, "/").removesuffix(".py").split("/")
    if "repro_torch" in parts:  # real tree: dotted from the package root
        parts = parts[parts.index("repro_torch"):]
    elif parts and parts[0] in ("src", "."):
        parts = parts[1:]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(p for p in parts if p not in ("", "."))


def collect_module(path: str, repo_root: str) -> ModuleInfo:
    with open(path) as f:
        source = f.read()
    lines = source.splitlines()
    tree = ast.parse(source, filename=path)
    mod = ModuleInfo(path=os.path.relpath(path, repo_root),
                     modname=_modname(path, repo_root), tree=tree,
                     lines=lines, suppressions=_suppressions(lines),
                     imports=_imports(tree))
    _FnCollector(mod).visit(mod.tree)
    return mod


# --------------------------------------------------------------------------
# reachability
# --------------------------------------------------------------------------

def _reachable(mods: list[ModuleInfo]) -> set[int]:
    """ids of FunctionInfos reachable from the pipeline roots.

    The roots are named by module and qualname (`PIPELINE_ROOTS`); from
    them every loaded name reaches every function of that name in the
    tree (a method only through an attribute: ``x.fits`` reaches the
    method ``fits``, a local variable ``fits`` does not), except the
    kernels' plain versions (`PLAIN_VERSIONS`), where the walk stops."""
    by_name: dict[str, list[FunctionInfo]] = {}
    by_attr: dict[str, list[FunctionInfo]] = {}
    for m in mods:
        stop = PLAIN_VERSIONS.get(m.modname, set())
        for fn in m.functions:
            if fn.qualname in stop:
                continue
            by_attr.setdefault(fn.name, []).append(fn)
            if not fn.method:
                by_name.setdefault(fn.name, []).append(fn)
    queue = [fn for m in mods for fn in m.functions
             if fn.qualname in PIPELINE_ROOTS.get(m.modname, ())]
    seen: set[int] = set()
    while queue:
        fn = queue.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        for table, loaded in ((by_name, fn.names), (by_attr, fn.attrs)):
            for name in loaded:
                queue.extend(g for g in table.get(name, ())
                             if id(g) not in seen)
    return seen


# --------------------------------------------------------------------------
# which values are tensors
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Env:
    """What one function's expressions are judged against: the module's
    imports and the function's local bindings (name -> every expression
    assigned to it)."""
    imports: dict[str, str]
    bindings: dict[str, list[ast.AST]]

    def canonical(self, dotted: str) -> str:
        head, _, rest = dotted.partition(".")
        full = self.imports.get(head, head)
        return f"{full}.{rest}" if rest else full


def _bindings(fn_node) -> dict[str, list[ast.AST]]:
    out: dict[str, list[ast.AST]] = {}

    def bind(target, value):
        if isinstance(target, ast.Name):
            out.setdefault(target.id, []).append(value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            same = (isinstance(value, (ast.Tuple, ast.List))
                    and len(value.elts) == len(target.elts))
            for i, e in enumerate(target.elts):
                bind(e, value.elts[i] if same else value)

    for sub in ast.walk(fn_node):
        if isinstance(sub, ast.Assign):
            for tgt in sub.targets:
                bind(tgt, sub.value)
        elif isinstance(sub, (ast.AnnAssign, ast.NamedExpr)) and sub.value:
            bind(sub.target, sub.value)
    return out


def _env(fn: FunctionInfo) -> _Env:
    return _Env(fn.module.imports, _bindings(fn.node))


def _host_torch(canon: str) -> bool:
    return canon in _HOST_TORCH_CALLS or canon.startswith(_HOST_TORCH_PREFIXES)


def _device_valued(node, env: _Env, depth: int = 0) -> bool:
    """Does this expression plausibly hold a tensor (device data)?"""
    if depth > 8 or node is None:
        return False
    nxt = depth + 1
    if isinstance(node, ast.Call):
        func = node.func
        d = _dotted(func)
        if d is not None:
            canon = env.canonical(d)
            if canon.split(".")[0] == "torch":
                return not _host_torch(canon)
            if d.split(".")[-1].endswith("_fn"):
                return True
        if isinstance(func, ast.Attribute):
            if func.attr in _META_METHODS:
                return False
            return _device_valued(func.value, env, nxt)
        if isinstance(func, ast.Name):
            return any(_device_valued(b, env, nxt)
                       for b in env.bindings.get(func.id, ()))
        return isinstance(func, ast.Call)  # factory(...)(...)
    if isinstance(node, ast.Name):
        return any(_device_valued(b, env, nxt)
                   for b in env.bindings.get(node.id, ()))
    if isinstance(node, ast.Attribute):
        return (node.attr not in _META_ATTRS
                and _device_valued(node.value, env, nxt))
    if isinstance(node, ast.Subscript):
        return _device_valued(node.value, env, nxt)
    if isinstance(node, ast.BinOp):
        return (_device_valued(node.left, env, nxt)
                or _device_valued(node.right, env, nxt))
    if isinstance(node, ast.UnaryOp):
        return _device_valued(node.operand, env, nxt)
    if isinstance(node, ast.BoolOp):
        return any(_device_valued(v, env, nxt) for v in node.values)
    if isinstance(node, ast.Compare):
        # identity and membership tests give Python bools
        if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
               for op in node.ops):
            return False
        return any(_device_valued(v, env, nxt)
                   for v in [node.left, *node.comparators])
    if isinstance(node, ast.IfExp):
        return (_device_valued(node.body, env, nxt)
                or _device_valued(node.orelse, env, nxt))
    return False


# --------------------------------------------------------------------------
# per-rule checks
# --------------------------------------------------------------------------

def _finding(rule: str, mod: ModuleInfo, node, message: str) -> Finding:
    line = getattr(node, "lineno", 1)
    text = mod.lines[line - 1].strip() if line <= len(mod.lines) else ""
    return Finding(rule=rule, path=mod.path, line=line,
                   col=getattr(node, "col_offset", 0),
                   message=message, hint=RULES[rule].hint, snippet=text)


def _in_scope(modname: str, dotted_pkg: str) -> bool:
    """modname is dotted_pkg or inside it (by dotted-path containment,
    so fixture trees like 'core.hot' scope like
    'repro_torch.core.hot')."""
    pad = f".{modname}."
    return f".{dotted_pkg.split('.')[-1]}." in pad or \
        modname.startswith(dotted_pkg)


def _check_sync_calls(fn: FunctionInfo, scope: str,
                      out: list[Finding]) -> None:
    mod = fn.module
    env = _env(fn)
    for sub in ast.walk(fn.node):
        if not isinstance(sub, ast.Call):
            continue
        func = sub.func
        if isinstance(func, ast.Attribute) and (
                func.attr in _SYNC_METHODS
                or (func.attr in _TENSOR_SYNC_METHODS
                    and _device_valued(func.value, env))):
            out.append(_finding(
                "R1", mod, sub,
                f".{func.attr}() waits for the card inside {scope} "
                f"{fn.qualname}"))
            continue
        d = _dotted(func)
        arg = sub.args[0] if sub.args else None
        if d and env.canonical(d) in _NP_FUNCS \
                and _device_valued(arg, env):
            out.append(_finding(
                "R1", mod, sub,
                f"{d}() copies a tensor to the host inside {scope} "
                f"{fn.qualname}"))
        elif isinstance(func, ast.Name) and func.id in _CASTS \
                and _device_valued(arg, env):
            out.append(_finding(
                "R1", mod, sub,
                f"{func.id}() of a tensor syncs the host inside {scope} "
                f"{fn.qualname}"))


def _check_r1(mods, reachable, out) -> None:
    for m in mods:
        hot = HOT_PATHS.get(m.modname, set())
        for fn in m.functions:
            if id(fn) in reachable:
                _check_sync_calls(fn, "pipeline-reachable", out)
            elif fn.qualname in hot:
                _check_sync_calls(fn, "serving hot path", out)


_LOOPS = (ast.For, ast.AsyncFor, ast.While, ast.ListComp, ast.SetComp,
          ast.DictComp, ast.GeneratorExp)
_R2_FUNCS = {"torch.nn.functional.pad"}
_R2_DEVICE_FUNCS = {"torch.as_tensor", "torch.tensor"}


def _is_device_arg(node, env: _Env) -> bool:
    """A positional ``.to()`` argument naming a device (not a dtype)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and \
            node.value.split(":")[0] in ("cuda", "cpu")
    if isinstance(node, ast.Call):
        d = _dotted(node.func)
        return d is not None and env.canonical(d) == "torch.device"
    d = _dotted(node)
    return d is not None and d.split(".")[-1] in ("device", "dev")


def _r2_call(call: ast.Call, env: _Env) -> str | None:
    """What a call does per item, if R2 forbids it in a loop."""
    func = call.func
    d = _dotted(func)
    canon = env.canonical(d) if d else None
    kws = {kw.arg for kw in call.keywords}
    if canon in _R2_FUNCS:
        return f"{d}()"
    if canon in _R2_DEVICE_FUNCS and "device" in kws:
        return f"{d}(..., device=...)"
    if isinstance(func, ast.Attribute):
        if func.attr == "cuda":
            return ".cuda()"
        if func.attr == "to" and ("device" in kws or (
                call.args and _is_device_arg(call.args[0], env))):
            return ".to(device)"
    return None


def _check_r2(mods, out) -> None:
    for m in mods:
        if not any(_in_scope(m.modname, f"repro_torch.{leaf}")
                   for leaf in R2_SCOPES):
            continue
        env = _Env(m.imports, {})
        flagged: set[int] = set()
        for loop in ast.walk(m.tree):
            if not isinstance(loop, _LOOPS):
                continue
            for sub in ast.walk(loop):
                if not isinstance(sub, ast.Call) or id(sub) in flagged:
                    continue
                what = _r2_call(sub, env)
                if what:
                    flagged.add(id(sub))
                    out.append(_finding(
                        "R2", m, sub,
                        f"per-item {what} inside a loop — ragged items "
                        f"must go through the bucketed pack"))


def _check_r3(mods, out) -> None:
    for m in mods:
        if _in_scope(m.modname, "repro_torch.kernels"):
            continue
        for node in ast.walk(m.tree):
            hits = []
            if isinstance(node, ast.ImportFrom) and node.module:
                if any(node.module.startswith(pkg + ".")
                       for pkg in KERNEL_INTERNALS):
                    hits.append(node.module)
                elif node.module in KERNEL_INTERNALS:
                    # the package surface (the registry-routed entries)
                    # is sanctioned; submodules are not
                    hits.extend(f"{node.module}.{a.name}"
                                for a in node.names
                                if a.name in KERNEL_SUBMODULES)
            elif isinstance(node, ast.Import):
                hits.extend(a.name for a in node.names
                            if any(a.name.startswith(pkg + ".")
                                   for pkg in KERNEL_INTERNALS))
            for h in hits:
                out.append(_finding(
                    "R3", m, node,
                    f"direct kernel-internal import {h} — call sites go "
                    f"through the kernel package's entry and "
                    f"repro_torch.kernels.backend"))


_R4_CALLS = {"init_process_group", "new_group"}


def _check_r4(mods, out) -> None:
    for m in mods:
        if m.modname == COMPAT_MODULE or \
                m.path.replace(os.sep, "/").endswith("repro_torch/launch/mesh.py"):
            continue
        for node in ast.walk(m.tree):
            msg = None
            if isinstance(node, ast.ImportFrom) and node.module:
                if node.module.startswith("torch.distributed"):
                    msg = f"raw import from {node.module}"
                elif node.module == "torch" and \
                        any(a.name == "distributed" for a in node.names):
                    msg = "raw import of torch.distributed"
            elif isinstance(node, ast.Import):
                if any(a.name.startswith("torch.distributed")
                       for a in node.names):
                    msg = "raw import of torch.distributed"
            elif isinstance(node, ast.Call):
                d = _dotted(node.func)
                if d and d.split(".")[-1] in _R4_CALLS:
                    msg = f"raw {d}() call"
            if msg:
                out.append(_finding(
                    "R4", m, node,
                    f"{msg} outside {COMPAT_MODULE} — process groups are "
                    f"made in the one mesh module"))


def _check_r5(mods, reachable, out) -> None:
    for m in mods:
        if not _in_scope(m.modname, "repro_torch.core"):
            continue
        for fn in m.functions:
            if id(fn) not in reachable:
                continue
            env = _env(fn)
            for sub in ast.walk(fn.node):
                if isinstance(sub, (ast.If, ast.While, ast.IfExp)) \
                        and _device_valued(sub.test, env):
                    out.append(_finding(
                        "R5", m, sub,
                        f"Python branch on a tensor in {fn.qualname} — "
                        f"use torch.where, or decide on a shape or a "
                        f"static value"))


def _returns_operand(node, param: str, bindings, depth: int = 0) -> bool:
    """Is this returned expression the ``param`` operand, updated: the
    operand itself, ``param._replace(...)``, a call handing ``param`` on
    as its first argument, or a local name bound to one of those?"""
    if depth > 8:
        return False
    if isinstance(node, ast.Name):
        return node.id == param or any(
            _returns_operand(b, param, bindings, depth + 1)
            for b in bindings.get(node.id, ()))
    if isinstance(node, ast.Call):
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr == "_replace" \
                and isinstance(func.value, ast.Name) \
                and func.value.id == param:
            return True
        return bool(node.args) and isinstance(node.args[0], ast.Name) \
            and node.args[0].id == param
    return False


def _writes_in_place(fn_node) -> bool:
    """An in-place torch method (``x.copy_(...)``, ``index_copy_``,
    ``add_``...: a public name ending in one underscore) or an ``out=``
    argument anywhere in the function."""
    for sub in ast.walk(fn_node):
        if not isinstance(sub, ast.Call):
            continue
        func = sub.func
        if isinstance(func, ast.Attribute) and func.attr.endswith("_") \
                and not func.attr.startswith("_"):
            return True
        if any(kw.arg == "out" for kw in sub.keywords):
            return True
    return False


def _is_donate(node) -> bool:
    return (isinstance(node, ast.Name) and node.id == "donate") or \
        (isinstance(node, ast.Attribute) and node.attr == "donate")


def _honours_donation(fn_node) -> bool:
    """Reads the donation flag and writes in place, or hands the flag
    to a callee (which is checked on its own)."""
    if not any(_is_donate(sub) for sub in ast.walk(fn_node)):
        return False
    if _writes_in_place(fn_node):
        return True
    for sub in ast.walk(fn_node):
        if isinstance(sub, ast.Call) and any(
                _is_donate(a) for a in
                [*sub.args, *(kw.value for kw in sub.keywords)]):
            return True
    return False


def _check_r6(mods, out) -> None:
    """State updates honour donation (R6).

    A *state update* is a ``core/`` or ``serve/`` function whose first
    parameter is named ``state`` or ``leaves`` (`STATE_OPERANDS`) and
    that returns that operand updated (see `_returns_operand`).  A
    ``state`` update must read the donation flag (``donate`` or
    ``cfg.donate``) and write in place or pass the flag on; a
    ``leaves`` update (the engine's arenas, always its own) must write
    in place.  Read-only overlays return new buffers and are no state
    updates; one that returns a shared state suppresses with a
    rationale."""
    for m in mods:
        if not any(_in_scope(m.modname, f"repro_torch.{leaf}")
                   for leaf in R6_SCOPES):
            continue
        for fn in m.functions:
            args = fn.node.args.args
            if not args or args[0].arg not in STATE_OPERANDS:
                continue
            param = args[0].arg
            bindings = _bindings(fn.node)
            returns = [sub for sub in ast.walk(fn.node)
                       if isinstance(sub, ast.Return) and sub.value]
            updates = [r for r in returns if _returns_operand(
                r.value.elts[0] if isinstance(r.value, ast.Tuple)
                and r.value.elts else r.value, param, bindings)]
            if not updates:
                continue
            ok = (_writes_in_place(fn.node) if param == "leaves"
                  else _honours_donation(fn.node))
            if ok:
                continue
            out.append(_finding(
                "R6", m, min(updates, key=lambda r: r.lineno),
                f"{fn.qualname} returns its updated `{param}` without "
                f"honouring donation — the update is an A/B copy instead "
                f"of an in-place write"))


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def _expand(paths) -> list[str]:
    files = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs.sort()
                files.extend(os.path.join(root, n)
                             for n in sorted(names) if n.endswith(".py"))
        else:
            files.append(p)
    return files


def lint_paths(paths, *, repo_root: str | None = None,
               baseline_keys=frozenset()) -> list[Finding]:
    """Run all rules over ``paths`` (files or directories).

    Returns EVERY finding; suppressed / baselined ones come back with
    the matching flag set (``Finding.active`` selects the gating set).
    """
    repo_root = repo_root or os.getcwd()
    mods = [collect_module(f, repo_root) for f in _expand(paths)]
    reachable = _reachable(mods)
    out: list[Finding] = []
    _check_r1(mods, reachable, out)
    _check_r2(mods, out)
    _check_r3(mods, out)
    _check_r4(mods, out)
    _check_r5(mods, reachable, out)
    _check_r6(mods, out)
    by_mod = {m.path: m for m in mods}
    for f in out:
        sup = by_mod[f.path].suppressions
        if f.rule in sup.get(f.line, ()):
            f.suppressed = True
        if f.key in baseline_keys:
            f.baselined = True
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out
