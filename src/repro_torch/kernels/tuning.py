"""Persistent per-topology kernel autotuner.

Counterpart of ``repro.kernels.tuning``.  :func:`calibrate_kernels` times
candidate kernel geometries per ``(family, d, dtype)`` on the
implementation that ``'auto'`` resolves to on the calibrating device,
checks every candidate bit for bit against the per-pair reference, and
keeps the winners as a :class:`TuningTable`, a JSON file that a serving
process loads:

    table = calibrate_kernels(engine)["table"]   # applied to the engine
    table.save("results/kernel_tuning.json")
    ...
    REPRO_KERNEL_TUNING=results/kernel_tuning.json python -m \\
        repro_torch.launch.serve

The table's JSON is the reference's, key for key (``version``,
``topology``, ``entries``; keys ``family/d=D/dtype=NAME`` with numpy's
dtype names), so a table written by either package loads in the other.

Resolution order when the engine answers an ``impl='auto'`` request: its
own table (``engine.kernel_tuning``, set by ``calibrate_kernels(engine)``),
else the process default (:func:`set_default_table`, loaded once from
``$REPRO_KERNEL_TUNING``; `repro_torch.launch.env` passes it on).  A
config that pins ``wtile``, or any impl other than ``'auto'``, is never
overridden.  Every geometry is schedule only (the sweep contract), so a
table changes speed, never an answer.

Two differences from the reference, both because of the card's kernels:

* When the resolved sweep is ``'cuda'``, the candidate grid is
  ``(block, 0)`` for each block up to the kernel's ``MAX_BLOCK``: the
  CUDA sweep stages the window in tiles of its own size, and ``wtile``
  reaches only the plain version (``kernels/sfs/ops.sfs_sweep``), so
  tiled candidates would run the same schedule and differ by noise.
  Under ``'torch'`` the grid is the reference's, ``(b, 0)``, ``(b, b)``
  and ``(b, 2b)`` where the tile divides the window.
* The dominance family has one candidate, named ``fixed`` and recorded
  as ``block=0, wtile=0``: the CUDA kernel's tile and walk shapes are
  compile-time constants, and the plain version's blocking is fixed
  too.  It is timed, held bit for bit against
  ``kernels/dominance/ref.dominated_mask_ref`` and kept in the table, so
  that both packages' tables have the same keys.

Timing is interleaved best-of-``repeat`` after one warm-up call per
candidate, which pays the kernels' build: CUDA events on the card,
``time.perf_counter`` on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Sequence

import numpy as np
import torch

__all__ = ["TuneEntry", "TuningTable", "calibrate_kernels",
           "default_table", "set_default_table", "tuning_key", "dtype_name",
           "sweep_candidates", "block_fits", "ENV_VAR"]

ENV_VAR = "REPRO_KERNEL_TUNING"


def dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype, or of a name: ``float32``,
    ``bfloat16`` (as the reference's ``jnp.dtype(dtype).name``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    try:
        return np.dtype(dtype).name
    except TypeError:
        return str(dtype)     # a name numpy lacks, such as "bfloat16"


def tuning_key(family: str, d: int, dtype) -> str:
    """Canonical table key: ``family/d=D/dtype=NAME``."""
    return f"{family}/d={int(d)}/dtype={dtype_name(dtype)}"


@dataclasses.dataclass(frozen=True)
class TuneEntry:
    """One winning kernel geometry for a (family, d, dtype) key."""
    block: int
    wtile: int
    time_us: float
    impl: str                 # the implementation the timing ran
    bitwise_ok: bool = True   # against the per-pair / oracle reference


@dataclasses.dataclass
class TuningTable:
    """Tuned (block, wtile) per ``family/d=D/dtype=NAME`` key, and the
    topology it was measured on (a table is valid anywhere; it is only
    best on the topology that made it)."""
    entries: dict[str, TuneEntry] = dataclasses.field(default_factory=dict)
    topology: dict[str, Any] = dataclasses.field(default_factory=dict)

    def lookup(self, family: str, d: int, dtype) -> TuneEntry | None:
        return self.entries.get(tuning_key(family, d, dtype))

    def __len__(self) -> int:
        return len(self.entries)

    def to_json(self) -> dict:
        return {"version": 1, "topology": self.topology,
                "entries": {k: dataclasses.asdict(e)
                            for k, e in self.entries.items()}}

    @classmethod
    def from_json(cls, doc: dict) -> "TuningTable":
        entries = {k: TuneEntry(**{f: v[f] for f in
                                   ("block", "wtile", "time_us", "impl",
                                    "bitwise_ok") if f in v})
                   for k, v in doc.get("entries", {}).items()}
        return cls(entries=entries, topology=doc.get("topology", {}))

    def save(self, path: str) -> str:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "TuningTable":
        with open(path) as f:
            return cls.from_json(json.load(f))


# -- process-default table (loaded from the environment) --------------------

_DEFAULT: TuningTable | None = None
_DEFAULT_LOADED = False


def set_default_table(table: TuningTable | None) -> None:
    """Install ``table`` as the process default (None clears it and
    re-arms the load from the environment)."""
    global _DEFAULT, _DEFAULT_LOADED
    _DEFAULT = table
    _DEFAULT_LOADED = table is not None


def default_table() -> TuningTable | None:
    """The process-default table: what `set_default_table` installed,
    else a one-time load from ``$REPRO_KERNEL_TUNING``.  A missing or
    invalid file gives None: an untuned process runs, it does not
    fail."""
    global _DEFAULT, _DEFAULT_LOADED
    if not _DEFAULT_LOADED:
        _DEFAULT_LOADED = True
        path = os.environ.get(ENV_VAR)
        if path:
            try:
                _DEFAULT = TuningTable.load(path)
            except (OSError, ValueError, KeyError, TypeError):
                _DEFAULT = None
    return _DEFAULT


# -- calibration -------------------------------------------------------------

def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-level equality (NaN-proof, -0.0-strict)."""
    a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return bool(np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def _interleaved_best(cands: dict[str, Any], repeat: int,
                      device: torch.device) -> dict[str, float]:
    """Best-of-``repeat`` time in seconds per candidate thunk, rounds
    interleaved (order alternated) so that clock drift and boost decay
    hit every candidate alike.  One warm-up call per candidate first
    (it pays the kernels' build).  CUDA events on the card,
    ``perf_counter`` elsewhere."""
    on_card = device.type == "cuda"
    for fn in cands.values():
        fn()
    if on_card:
        torch.cuda.synchronize(device)
    best = {k: float("inf") for k in cands}
    for r in range(repeat):
        order = list(cands) if r % 2 == 0 else list(reversed(cands))
        for k in order:
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                cands[k]()
                end.record()
                end.synchronize()
                took = start.elapsed_time(end) * 1e-3
            else:
                t0 = time.perf_counter()
                cands[k]()
                took = time.perf_counter() - t0
            best[k] = min(best[k], took)
    return best


def _sweep_candidates(blocks: Sequence[int], capacity: int,
                      ) -> list[tuple[int, int]]:
    """The reference's (block, wtile) grid: untiled, one-block and
    two-block tiles per block size, kept where the tile divides that
    block's window."""
    out = []
    for b in blocks:
        wcap = _ceil_to(capacity, b)
        for t in (0, b, 2 * b):
            if t > wcap or (t and wcap % t):
                continue
            out.append((b, t))
    return out


def block_fits(sweep: str, block: int, d: int) -> bool:
    """Whether the sweep implementation ``sweep`` takes ``block`` at
    ``d``: the CUDA kernel takes 1..``MAX_BLOCK`` where its footprint law
    fits the card's per-CTA limit, the others any positive block."""
    if sweep == "cuda":
        from repro_torch.kernels.sfs.kernel import (MAX_BLOCK, SMEM_LIMIT,
                                                    sweep_smem_bytes)
        return 1 <= block <= MAX_BLOCK and \
            max(sweep_smem_bytes(d, block).values()) <= SMEM_LIMIT
    return block >= 1


def sweep_candidates(sweep: str, blocks: Sequence[int], capacity: int,
                     d: int) -> list[tuple[int, int]]:
    """The (block, wtile) candidates of the resolved sweep ``sweep``:
    ``(b, 0)`` for each block the CUDA kernel takes under ``'cuda'`` at
    ``d`` (``wtile`` does not reach it), the reference's grid otherwise."""
    if sweep == "cuda":
        return [(b, 0) for b in blocks if block_fits(sweep, b, d)]
    return _sweep_candidates(blocks, capacity)


def calibrate_kernels(engine=None, *,
                      ds: Sequence[int] = (4,),
                      dtypes: Sequence[Any] = (torch.float32,),
                      n: int = 16_384, p: int = 8,
                      capacity: int | None = None,
                      blocks: Sequence[int] = (128, 256, 512),
                      repeat: int = 3, apply: bool = True,
                      verify: bool = True,
                      path: str | None = None,
                      device=None) -> dict[str, Any]:
    """Time candidate kernel geometries and build the winning
    :class:`TuningTable`.

    For every ``(d, dtype)``: the *sweep* family times each candidate
    ``(block, wtile)`` (see `sweep_candidates`) through
    `local_skyline_batch` on a ``(p, n/p, d)`` batch of coordinates
    quantised at 1/64, drawn from ``default_rng(d * 1000 + 17)`` (the
    reference's arrays); the *dominance* family times its one ``fixed``
    geometry through `dominated_mask` on the first partition against
    itself.  With ``verify=True`` every sweep candidate must match
    ``impl='perpair'`` bit for bit (points, mask, count), and the
    dominance call the oracle, before it may win; a divergent one is
    recorded with ``bitwise_ok=False`` and its key listed under
    ``divergent``.

    ``engine`` supplies the config whose ``'auto'`` resolution the table
    serves (capacity, impl) and its device, and with ``apply=True``
    receives the table as ``engine.kernel_tuning``; ``engine=None``
    calibrates the default `SkyConfig` on ``device`` (the card unless
    ``"cpu"``) and installs the table with `set_default_table`.  ``path``
    also saves the JSON.  The port's pipeline runs float32 only, so
    ``dtypes`` must be float32.  Returns a report (``table``, per-key
    candidate times and checks, ``divergent`` keys)."""
    from repro_torch.core.parallel import SkyConfig
    from repro_torch.core.sfs import local_skyline_batch
    from repro_torch.kernels.backend import resolve_device, resolve_spec
    from repro_torch.kernels.dominance import (dominated_mask,
                                               dominated_mask_ref)

    cfg = engine.cfg if engine is not None else SkyConfig()
    dev = engine.device if engine is not None else resolve_device(device)
    capacity = int(capacity or cfg.capacity)
    spec = resolve_spec(cfg.impl, dev)
    for dtype in dtypes:
        if dtype_name(dtype) != "float32":
            raise ValueError(f"the port's pipeline runs float32 points; "
                             f"cannot calibrate dtype {dtype_name(dtype)}")
    topology = {"platform": dev.type,
                "devices": (torch.cuda.device_count()
                            if dev.type == "cuda" else 1),
                "impl": spec.name, "n": int(n), "p": int(p),
                "capacity": capacity}
    if dev.type == "cuda":
        topology["device_name"] = torch.cuda.get_device_name(dev)
    table = TuningTable(topology=topology)
    report: dict[str, Any] = {"impl": spec.name, "keys": {},
                              "divergent": []}

    psz = _ceil_to(max(n // max(p, 1), 1), max(blocks))
    for d in ds:
        for dtype in dtypes:
            rng = np.random.default_rng(d * 1000 + 17)
            # quantised coordinates: dense dominance ties, where the
            # window test does real work
            pts = torch.from_numpy(
                (np.round(rng.random((p, psz, d)) * 64) / 64)
                .astype(np.float32)).to(dev)
            mask = torch.ones((p, psz), dtype=torch.bool, device=dev)

            # --- sweep family: (block, wtile) candidates ---------------
            cands = sweep_candidates(spec.sweep, blocks, capacity, d)
            thunks = {
                f"b{b}/t{t}": (lambda b=b, t=t: local_skyline_batch(
                    pts, mask, capacity=capacity, block=b,
                    impl=cfg.impl, wtile=t).points)
                for (b, t) in cands}
            times = _interleaved_best(thunks, repeat, dev)
            if verify:
                ok = {}
                for (b, t) in cands:
                    got = local_skyline_batch(pts, mask, capacity=capacity,
                                              block=b, impl=cfg.impl,
                                              wtile=t)
                    ref = local_skyline_batch(pts, mask, capacity=capacity,
                                              block=b, impl="perpair")
                    ok[f"b{b}/t{t}"] = all(
                        _bitwise_equal(g, r) for g, r in
                        zip(got[:3], ref[:3]))
            else:
                ok = {k: True for k in thunks}
            key = tuning_key("sweep", d, dtype)
            report["keys"][key] = {
                "times_us": {k: round(v * 1e6, 2) for k, v in times.items()},
                "bitwise_ok": ok}
            valid = [k for k in times if ok[k]]
            if not cands:
                pass              # no block's law fits at this d
            elif not valid:
                report["divergent"].append(key)
            else:
                win = min(valid, key=times.get)
                wb, wt = (int(x[1:]) for x in win.split("/"))
                table.entries[key] = TuneEntry(
                    block=wb, wtile=wt, time_us=round(times[win] * 1e6, 2),
                    impl=spec.name, bitwise_ok=all(ok[k] for k in valid))
                if not all(ok.values()):
                    report["divergent"].append(key)

            # --- dominance family: its one fixed geometry ---------------
            flat, fm = pts[0], mask[0]
            dtimes = _interleaved_best(
                {"fixed": lambda: dominated_mask(flat, flat, fm,
                                                 impl=spec.dominance)},
                repeat, dev)
            dok = {"fixed": (not verify) or _bitwise_equal(
                dominated_mask(flat, flat, fm, impl=spec.dominance),
                dominated_mask_ref(flat, flat, fm))}
            dkey = tuning_key("dominance", d, dtype)
            report["keys"][dkey] = {
                "times_us": {k: round(v * 1e6, 2)
                             for k, v in dtimes.items()},
                "bitwise_ok": dok}
            if not dok["fixed"]:
                report["divergent"].append(dkey)
            else:
                table.entries[dkey] = TuneEntry(
                    block=0, wtile=0,
                    time_us=round(dtimes["fixed"] * 1e6, 2),
                    impl=spec.dominance, bitwise_ok=True)

    if apply:
        if engine is not None:
            engine.kernel_tuning = table
        else:
            set_default_table(table)
    if path:
        table.save(path)
        report["path"] = path
    report["table"] = table
    report["applied"] = apply
    return report
