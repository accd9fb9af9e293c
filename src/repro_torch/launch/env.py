"""Launch environment for reproducible serve and measurement runs.

Counterpart of ``repro.launch.env``.  Numbers are only comparable when
every run sees the same allocator: python's default malloc fragments
under the engine's host-staging churn, and tcmalloc is the usual fix on
accelerator hosts.  `build_env` derives the environment, `apply_env`
merges it into ``os.environ`` (without overwriting what the user
pinned), and ``python -m repro_torch.launch.env CMD ...`` execs a
command under it:

    python -m repro_torch.launch.env --tuning table.json \\
        python -m repro_torch.launch.serve --queues 2

Also passed on here: ``REPRO_KERNEL_TUNING``, the path of a kernel-tuning
table (`repro_torch.kernels.tuning`), so that a calibrated table reaches
every child process of a launch as the allocator settings do.

What the port leaves out of the reference's environment:

* ``TF_CPP_MIN_LOG_LEVEL``: no part of the port reads it.
* ``--devices N`` / ``devices=``: the reference forces N XLA host
  devices.  Torch has no such devices; the port's multi-device worlds
  are processes (`repro_torch.launch.mesh.run_world`), sized by
  ``--world`` of ``python -m repro_torch.analysis`` and of
  ``python -m repro_torch.launch.dryrun``.  So the flag, and a
  ``devices`` argument, are refused with a message that says so.

LD_PRELOAD only takes effect at process start, so `apply_env` cannot
change the allocator of the *current* process: use the ``-m`` exec form
(or export the returned mapping from a shell) for that.
"""

from __future__ import annotations

import os
import sys

__all__ = ["TCMALLOC_PATHS", "build_env", "apply_env", "main"]

# well-known tcmalloc locations (Debian/Ubuntu multiarch first)
TCMALLOC_PATHS = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
)

_NO_DEVICES = ("--devices forces XLA host devices, which torch does not "
               "have: the port's worlds are processes; size them with "
               "--world of `python -m repro_torch.analysis` or of "
               "`python -m repro_torch.launch.dryrun`")


def _find_tcmalloc() -> str | None:
    for path in TCMALLOC_PATHS:
        if os.path.exists(path):
            return path
    return None


def build_env(*, devices: int | None = None,
              tuning: str | None = None) -> dict[str, str]:
    """The launch environment as a plain mapping.

    Args:
      devices: refused unless None (see the module docstring).
      tuning: path of a kernel-tuning table JSON to expose as
        ``REPRO_KERNEL_TUNING``.

    Returns only the variables this module owns; callers merge.
    """
    if devices is not None:
        raise ValueError(_NO_DEVICES)
    env: dict[str, str] = {
        # keep large-allocation reports out of tcmalloc runs
        "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000",
    }
    tc = _find_tcmalloc()
    if tc is not None:
        env["LD_PRELOAD"] = tc
    if tuning is not None:
        env["REPRO_KERNEL_TUNING"] = tuning
    return env


def apply_env(*, devices: int | None = None, tuning: str | None = None,
              overwrite: bool = False) -> dict[str, str]:
    """Merge `build_env` into ``os.environ``; returns what was applied.

    User-pinned variables win unless ``overwrite=True``.  See the
    LD_PRELOAD caveat in the module docstring."""
    applied = {}
    for key, val in build_env(devices=devices, tuning=tuning).items():
        if overwrite or key not in os.environ:
            os.environ[key] = val
            applied[key] = val
    return applied


def main(argv: list[str] | None = None) -> None:
    """``python -m repro_torch.launch.env [--tuning PATH] CMD ...``:
    exec CMD under the launch environment (LD_PRELOAD included)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    tuning = None
    while argv and argv[0].startswith("--"):
        flag = argv.pop(0)
        if flag == "--devices":
            sys.exit(_NO_DEVICES)
        elif flag == "--tuning":
            if not argv:
                sys.exit("--tuning needs a PATH")
            tuning = argv.pop(0)
        else:
            sys.exit(f"unknown flag {flag!r} (have --tuning PATH)")
    if not argv:
        sys.exit("usage: python -m repro_torch.launch.env [--tuning PATH] "
                 "CMD [ARG ...]")
    env = dict(os.environ)
    env.update(build_env(tuning=tuning))
    os.execvpe(argv[0], argv, env)


if __name__ == "__main__":
    main()
