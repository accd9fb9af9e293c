#!/usr/bin/env python3
"""Run ``chip_smoke.py`` and stamp each line of its output with the
seconds since the start, to see which of its steps take the time (the
script itself prints only each step's own total).

Run from the root of a checkout, on the host with the card:

    python3 chip_timeline.py [OUT_DIR] [-- chip_smoke.py arguments]

It writes ``OUT_DIR/timeline.log`` (the stamped standard output) and
``OUT_DIR/timeline_err.log`` (standard error), by default under
``chiprun_out/``, prints the exit code and the wall time, and exits
with ``chip_smoke.py``'s code.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    args = sys.argv[1:]
    extra = []
    if "--" in args:
        extra = args[args.index("--") + 1:]
        args = args[:args.index("--")]
    root = Path(__file__).resolve().parent
    out_dir = Path(args[0]) if args else root / "chiprun_out"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(out_dir / "timeline.log", "w") as out, \
            open(out_dir / "timeline_err.log", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-u", str(root / "chip_smoke.py"), *extra],
            cwd=root, stdout=subprocess.PIPE, stderr=err, text=True)
        for line in proc.stdout:
            out.write(f"{time.perf_counter() - t0:8.1f} {line}")
            out.flush()
        rc = proc.wait()
    print(f"chip_smoke.py exited {rc} after {time.perf_counter() - t0:.1f} s")
    return rc


if __name__ == "__main__":
    sys.exit(main())
