"""Builds the port's CUDA sources with ``nvcc`` at first use.

Every ``kernels/**/csrc/*.cu`` file is one shared library with a plain C
interface, loaded with ``ctypes``.  The library's file name carries a
hash of its source and of the compiler flags, so an edited source is
rebuilt and an unchanged one is built once.  Libraries and the
compiler's ``-Xptxas -v`` report go to ``build/repro_torch/`` at the
root of the checkout.

Nothing is built when this module is imported: :func:`library` builds
on the first launch, and :func:`build_all` builds every source at once,
one ``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "sources", "build_all", "library",
           "build_log"]

_PKG = Path(__file__).resolve().parents[1]          # src/repro_torch
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"

# --ftz=true: f32 comparisons, min/max and arithmetic treat a subnormal
# operand or result as a zero of its sign, as XLA does on the CPU (the
# reference); loads, stores and moves keep the stored bits
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "--ftz=true", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def sources() -> dict[str, Path]:
    """Library name -> CUDA source, for every source of the package."""
    return {p.stem: p for p in sorted(_PKG.glob("kernels/**/csrc/*.cu"))}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "CUDA kernels are built on a host with the toolkit")


def _target(src: Path) -> Path:
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all() -> dict[str, Path]:
    """Build every source whose library is missing, in parallel.

    Returns library name -> path.  Raises with the compiler's output if
    any build fails."""
    srcs = sources()
    targets = {name: _target(src) for name, src in srcs.items()}
    todo = {name: t for name, t in targets.items() if not t.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, target in todo.items():
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}:\n{out}")
                continue
            todo[name].with_suffix(".log").write_text(out)
            os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build_all()[name]))


def build_log(name: str) -> str:
    """The compiler's report (``-Xptxas -v``) for library ``name``."""
    return build_all()[name].with_suffix(".log").read_text()
