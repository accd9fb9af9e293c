"""Checkpointing: atomic, optionally asynchronous, with latest-k
retention.

Counterpart of ``repro.checkpoint.manager``, file for file.  Layout:
``<dir>/step_<N>/`` with one ``.npy`` per leaf and a ``manifest.json``
carrying the leaves' keys and the caller's ``extra`` (the data cursor).
Writes go to ``step_<N>.tmp`` and are renamed atomically, so a crash
mid-write never spoils the latest valid checkpoint.

The leaf keys are the reference's, which it derives from JAX key paths:
dict keys in sorted order as ``['key']``, list and tuple indices as
``[i]``, named-tuple fields as ``.name``, joined by ``/`` with every
character outside ``[A-Za-z0-9_.-]`` written as ``_`` (``{'w': [x]}``
gives ``__w__/_0_``); a file name is the key with ``/`` written as
``__``.  None is an empty subtree.  So either package reads the other's
checkpoints (`repro_torch.convert` needs nothing for them).  A bfloat16
leaf is written as the reference writes it, its two bytes under
ml_dtypes' ``<V2`` header, and read back into a bfloat16 target bit for
bit.

The state is a nest of dicts, lists, tuples and named tuples whose
leaves are tensors, numpy arrays or scalars.  ``restore`` returns
tensors in the target's structure: on each target tensor's device, or
where ``shardings`` says (a device for every leaf, or a nest of devices
shaped like the target).  The reference's elastic restore onto a mesh
(``NamedSharding`` leaves) is not ported: that needs the sharding
layer, ROADMAP item 14c.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]

_UNSAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """``(path element, child)`` pairs of a container in JAX's flatten
    order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(tree)]
    return None


def _flatten(state) -> dict:
    """``{key: leaf}`` in JAX's flatten order, keyed as the reference
    keys its files."""
    keyed = {}

    def walk(tree, path):
        if tree is None:
            return
        kids = _children(tree)
        if kids is None:
            keyed["/".join(_UNSAFE.sub("_", p) for p in path)] = tree
            return
        for p, child in kids:
            walk(child, path + (p,))

    walk(state, ())
    return keyed


def _rebuild(tree, fn, path=()):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn("/".join(_UNSAFE.sub("_", p) for p in path), tree)
    new = [_rebuild(child, fn, path + (p,)) for p, child in kids]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), new))
    if _is_namedtuple(tree):
        return type(tree)(*new)
    return type(tree)(new)


def _to_host(leaf) -> np.ndarray:
    """A leaf as the numpy array the reference would save."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _save_npy(path: str, arr: np.ndarray) -> None:
    """``np.save``, except that a bfloat16 leaf's two bytes carry the
    header the reference writes for them (``'<V2'``, ml_dtypes'
    descriptor), so the files are the same byte for byte."""
    if arr.dtype.kind != "V" or arr.dtype.itemsize != 2:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _from_host(arr: np.ndarray, target, device) -> torch.Tensor:
    """A loaded array as a tensor of the target's dtype on ``device``."""
    if isinstance(target, torch.Tensor):
        if target.dtype == torch.bfloat16 and arr.dtype.kind == "V":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, order="C")).to(target.dtype)
    else:
        if hasattr(target, "dtype"):
            arr = arr.astype(target.dtype)
        t = torch.as_tensor(np.array(arr, order="C"))
    return t.to(device)


def save(ckpt_dir: str, step: int, state, extra: dict | None = None):
    """Synchronous atomic save; returns the checkpoint's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    keyed = _flatten(state)
    manifest = {"step": step, "keys": list(keyed), "extra": extra or {}}
    for key, leaf in keyed.items():
        _save_npy(os.path.join(tmp, key.replace("/", "__") + ".npy"),
                  _to_host(leaf))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, target_state, step: int | None = None,
            shardings=None):
    """Restore into the structure of ``target_state``; returns
    ``(state, step, extra)``.  Each leaf takes its target's dtype and
    lands on the target tensor's device, or on ``shardings``: one device
    for every leaf, or a nest of devices shaped like the target (a
    target leaf that is not a tensor and has no device given lands on
    the card)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if shardings is None or isinstance(shardings, (str, torch.device)):
        devices = None
        every = None if shardings is None else resolve_device(shardings)
    else:
        devices = _flatten(shardings)
        every = None

    def load(key, target):
        arr = np.load(os.path.join(d, key.replace("/", "__") + ".npy"))
        if devices is not None:
            dev = resolve_device(devices[key])
        elif every is not None:
            dev = every
        elif isinstance(target, torch.Tensor):
            dev = target.device
        else:
            dev = resolve_device(None)
        return _from_host(arr, target, dev)

    return _rebuild(target_state, load), step, manifest.get("extra", {})


class CheckpointManager:
    """Asynchronous writer with latest-k retention."""

    def __init__(self, ckpt_dir: str, keep: int = 3, async_save: bool = True):
        self.dir = ckpt_dir
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(
            int(m.group(1)) for d in os.listdir(self.dir)
            if (m := re.fullmatch(r"step_(\d+)", d)))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    def save(self, step: int, state, extra: dict | None = None):
        # copy to the host *before* handing to the writer thread, so the
        # caller may write its device buffers in place meanwhile
        host_state = _rebuild(state, lambda _, leaf: _to_host(leaf))
        self.wait()

        def work():
            save(self.dir, step, host_state, extra)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def restore(self, target_state, step=None, shardings=None):
        self.wait()
        return restore(self.dir, target_state, step, shardings)
