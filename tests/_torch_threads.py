"""One intra-op thread for the port's test processes.

Importing this module sets ``torch.set_num_threads(1)``.  Every
``tests/test_torch_*.py`` imports it before any torch work.  The port's
test tensors are small, so torch's thread pool gains nothing on them,
and beside pytest-xdist's other workers its spinning threads fight over
the host's cores: six workers with eight threads each ran the slab tests
at least ten times slower than one thread each.  JAX's threads are not
touched.

`python_m` builds the command line of a ``python -m MODULE`` subprocess
that also runs torch on one thread (no environment variable is set, so
nothing leaks into other processes).
"""

from __future__ import annotations

import sys

import torch

torch.set_num_threads(1)

_PRELUDE = ("import runpy, torch; torch.set_num_threads(1); "
            "runpy.run_module({!r}, run_name='__main__', alter_sys=True)")


def python_m(module: str, *args: str) -> list[str]:
    """``[python, ...]`` running ``python -m module args...`` with torch
    on one intra-op thread."""
    return [sys.executable, "-c", _PRELUDE.format(module), *args]
