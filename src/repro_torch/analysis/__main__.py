"""CLI for the port's static verifier: ``python -m repro_torch.analysis``.

Exit codes: 0 clean, 1 active findings / failed invariants, 2 usage.
``--json`` writes the full machine-readable report; findings always
print human-readable to stdout.

The lint layer imports neither torch nor jax.  The verify layer runs
the program suite on the card unless ``--device cpu`` is given; without
CUDA it raises, as every entry point of the port does.  ``--world W``
(with ``--device cpu``) runs it in every rank of a gloo world of W
processes, the cells on their meshes scaled to W ranks.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    default_root = os.path.abspath(os.path.join(here, "..", "..", ".."))
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static verifier of the PyTorch port: AST lint "
                    "(skylint) + dispatched-program invariant checks")
    ap.add_argument("--layer", choices=("lint", "verify", "all"),
                    default="all")
    ap.add_argument("--paths", nargs="*", default=None,
                    help="files/dirs for the lint layer "
                         "(default: src/repro_torch)")
    ap.add_argument("--cells", nargs="*", default=None,
                    help="restrict the verify layer to these cells")
    ap.add_argument("--json", metavar="FILE", default=None,
                    help="write the full JSON report here ('-' = stdout)")
    ap.add_argument("--baseline", default=os.path.join(here,
                                                       "baseline.json"))
    ap.add_argument("--write-baseline", action="store_true",
                    help="record current lint findings as the baseline")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="where the verify layer runs (default: the card)")
    ap.add_argument("--smem-cap", type=int, default=None,
                    help="per-CTA shared-memory cap in bytes (default: "
                         "the sm_90 opt-in, 232448)")
    ap.add_argument("--world", type=int, default=None, metavar="W",
                    help="run the verify layer in every rank of a gloo "
                         "world of W CPU processes (needs --device cpu)")
    ap.add_argument("--mem-cap", type=int, default=None,
                    help="per-cell device peak-memory budget in bytes "
                         "(default 64 MiB; measured on the card only)")
    args = ap.parse_args(argv)

    report: dict = {"layers": {}}
    failed = False

    if args.layer in ("lint", "all"):
        from repro_torch.analysis.findings import (load_baseline,
                                                   write_baseline)
        from repro_torch.analysis.lint import lint_paths
        paths = args.paths or [os.path.join(default_root, "src",
                                            "repro_torch")]
        findings = lint_paths(paths, repo_root=default_root,
                              baseline_keys=load_baseline(args.baseline))
        if args.write_baseline:
            n = write_baseline([f for f in findings if not f.suppressed],
                               args.baseline)
            print(f"baseline: wrote {n} entries to {args.baseline}")
            for f in findings:
                f.baselined = not f.suppressed
        active = [f for f in findings if f.active]
        for f in findings:
            print(f)
            if f.active:
                print(f"    hint: {f.hint}")
        report["layers"]["lint"] = {
            "findings": [f.to_json() for f in findings],
            "active": len(active)}
        print(f"skylint: {len(findings)} finding(s), "
              f"{len(active)} active")
        failed |= bool(active)

    if args.layer in ("verify", "all"):
        from repro_torch.analysis.verifier import (DEFAULT_MEM_CAP,
                                                   DEFAULT_SMEM_CAP,
                                                   verify_programs,
                                                   verify_world)
        caps = dict(smem_cap=args.smem_cap or DEFAULT_SMEM_CAP,
                    mem_cap=args.mem_cap or DEFAULT_MEM_CAP)
        if args.world is not None and args.device != "cpu":
            ap.error("--world runs gloo CPU ranks: pass --device cpu")
        try:
            if args.world is not None:
                vreport, errors = verify_world(args.cells, ranks=args.world,
                                               **caps)
            else:
                vreport, errors = verify_programs(args.cells,
                                                  device=args.device, **caps)
        except ValueError as e:  # unknown cell names
            ap.error(str(e))
        vreport["errors"] = errors
        report["layers"]["verify"] = vreport
        for e in errors:
            print(f"VERIFY {e}")
        print(f"verifier: {len(vreport['cells'])} program(s) on "
              f"{vreport['device']}, {len(errors)} invariant violation(s)")
        failed |= bool(errors)

    report["ok"] = not failed
    if args.json == "-":
        json.dump(report, sys.stdout, indent=1, default=str)
        print()
    elif args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1, default=str)
        print(f"report: {args.json}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
