"""The skylint rule set of the port: the invariants its AST layer enforces.

Counterpart of ``repro.analysis.rules``, with the reference's rule ids
and each rule rewritten for PyTorch on the card.  The checks live in
`repro_torch.analysis.lint`; this module says WHAT each rule means, its
fix-hint, and where it applies.

The port has no ``jax.jit``.  "Jit-reachable" becomes *pipeline-
reachable*: reachable (by the repo-wide bare-name call graph) from a
function that the reference jits, listed in `PIPELINE_ROOTS`.  What runs
there is the per-dispatch device program, launched from the host with
no wait, so a host read in it serializes what the reference's one
dispatch keeps asynchronous.

Suppression: append ``# skylint: disable=R1`` (comma-separate several
ids) to the offending line, or put it on a comment-only line directly
above.  Suppressions carry a justification comment; the gate reports
them as suppressed, not as clean.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Rule", "RULES", "HOT_PATHS", "PIPELINE_ROOTS", "PLAIN_VERSIONS",
           "KERNEL_INTERNALS", "KERNEL_SUBMODULES", "R2_SCOPES", "R6_SCOPES",
           "STATE_OPERANDS", "COMPAT_MODULE"]


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    title: str
    rationale: str
    hint: str


RULES = {
    "R1": Rule(
        "R1", "no host syncs in pipeline-reachable code or serving hot "
        "paths",
        "A `.item()` / `.tolist()` / `.cpu()` / `.numpy()` of a tensor, "
        "`int()/float()/bool()` or `np.asarray()` of a tensor, or a "
        "`synchronize()` makes the host wait for the card.  On the "
        "pipeline and on the serving calls that wait is once per "
        "dispatch: it drains the launch queue that the host keeps ahead "
        "of the card, so the serve loop's dispatch-ahead runs one wave "
        "at a time.",
        "keep the value on the card and select with torch.where / "
        "index ops, or move the read behind the dispatch: copy into "
        "pinned memory with non_blocking=True, record a CUDA event, and "
        "read when event.query() says it arrived (see _WaveRecord and "
        "SkylineStream._maybe_resolve); if the sync is a considered "
        "cost, suppress with a justification comment."),
    "R2": Rule(
        "R2", "no eager per-item shaping in pack paths",
        "Padding or moving items to the card one at a time inside a "
        "Python loop makes O(items) small copies and launches, each a "
        "host-to-device transfer from pageable memory, and defeats the "
        "two-level bucketed pack (one staging copy per size bucket).",
        "stage the ragged items on the host in one buffer (pinned when "
        "the target is the card) and move it with one "
        ".to(device, non_blocking=True), as SkylineEngine._pack does "
        "through _stage_rows."),
    "R3": Rule(
        "R3", "kernel internals only via the kernel packages and the "
        "backend registry",
        "Importing repro_torch.kernels.sfs.* / repro_torch.kernels."
        "dominance.* submodules directly pins a call site to one "
        "implementation; the families' entries (sfs_sweep, "
        "dominated_mask) resolve through the backend registry, which "
        "is what lets 'auto' pick the CUDA kernel on the card and the "
        "plain version on the CPU, and what the verifier's census hooks.",
        "import the entry from the family's package (from "
        "repro_torch.kernels.sfs import sfs_sweep; from "
        "repro_torch.kernels.dominance import dominated_mask) and "
        "resolve_spec / resolve_device from repro_torch.kernels.backend."),
    "R4": Rule(
        "R4", "torch.distributed only through the mesh module",
        "Process groups and collectives are set up in one place "
        "(repro_torch.launch.mesh, the counterpart of repro.compat), so "
        "that the collective census and the device rule see every "
        "communicator; a raw torch.distributed import or "
        "init_process_group elsewhere makes a second, unaudited one.",
        "take the mesh and its groups from repro_torch.launch.mesh."),
    "R5": Rule(
        "R5", "no Python branching on tensor values in core/ pipeline "
        "code",
        "`if`/`while`/ternary on a tensor calls bool(tensor): an "
        "implicit .item(), a host sync inside the pipeline, and a "
        "graph-capture failure on the card.",
        "use torch.where / masked ops on the tensor, or decide on a "
        "shape or a static configuration value (a Python int)."),
    "R6": Rule(
        "R6", "state updates must honour donation",
        "A core/ or serve/ function whose first parameter is the "
        "`state` or `leaves` operand and that returns the updated state "
        "must write it in place when donation is on "
        "(SkyConfig.donate, the reference's donate_argnums); otherwise "
        "every insert holds the input AND the output state live, "
        "doubling the fleet's steady-state device bytes.  Arena "
        "`leaves` are the engine's own and are always written in place.",
        "read `donate` / `cfg.donate` and write through in-place ops "
        "(copy_, index_copy_, index_put_, out=), or pass the flag to "
        "the callee that does; arena-leaves updates write in place "
        "unconditionally.  A read-only overlay that returns a state "
        "shared with its caller suppresses with a rationale."),
}

# R1's first scope: the call-graph roots, the functions the reference
# jits (its per-dispatch device programs), by module.  Everything
# reachable from them by the bare-name call graph is checked.
PIPELINE_ROOTS = {
    "repro_torch.core.parallel": {
        "fused_skyline_batch_fn", "partition_stage", "local_stage",
        "merge_stage",
    },
    "repro_torch.core.incremental": {"_insert_batch"},
    "repro_torch.core.windowed": {
        "insert_chunk", "finalize", "window_tick", "advance_epoch",
        "expire_epoch",
    },
    "repro_torch.serve.engine": {
        "_slab_feed", "_slab_snapshot", "_slab_promote",
    },
}

# Where the reachability walk stops: each kernel family's plain
# version (and the per-pair oracle).  On the card the family's entry
# launches the CUDA kernel (one launch, held under
# set_sync_debug_mode("error") and a graph capture by the verifier's
# card phase); the plain version runs in its place only on the CPU, or
# on the card when a caller names it, and bounds its loops from the
# data on the host by design.  The entries and the CUDA wrappers are
# walked.
PLAIN_VERSIONS = {
    "repro_torch.kernels.sfs.ops": {"sfs_sweep_torch", "_sweep_perpair"},
    "repro_torch.kernels.sfs.ref": {"sfs_sweep_perpair"},
    "repro_torch.kernels.dominance.ops": {"dominated_mask_torch"},
}

# R1's second scope: serving-path methods that are NOT pipeline-
# reachable (they run on the host) but sit on the per-feed critical
# path, where a blocking device read serializes the dispatch all the
# same.  The reference's list, one for one.  NOT listed (the sanctioned
# blocking points, never on a serving call's path): _WaveRecord.host_fits
# / host_counts (read after event.query() said the copy arrived),
# SkylineStream.counters, SkylineStream._force_resolve / drain, and the
# completion thread's wave.event.synchronize() (ServeLoop._complete_loop).
HOT_PATHS = {
    "repro_torch.serve.engine": {
        "SkylineStream.feed", "SkylineStream.tick",
        "SkylineStream.expire_epoch", "SkylineStream._promote",
        "SkylineStream.snapshot", "SkylineStream._maybe_resolve",
        "_wave_feed",
        "SkylineEngine.run", "SkylineEngine._run_stacked",
        "SkylineEngine.submit", "SkylineEngine.submit_many",
        "SkylineEngine.member_masks",
    },
    "repro_torch.serve.loop": {
        "ServeLoop.submit", "ServeLoop.feed", "ServeLoop._stage_once",
        "ServeLoop._stage_loop", "ServeLoop._admit_locked",
    },
}

# R3: these packages' SUBMODULES are internal; the package __init__
# exports the sanctioned entries (which route through resolve_spec), so
# only submodule imports are violations, and only outside the kernels
# package itself.
KERNEL_INTERNALS = ("repro_torch.kernels.sfs", "repro_torch.kernels.dominance")
KERNEL_SUBMODULES = ("kernel", "ops", "ref")

# R2 applies where ragged request data is shaped for dispatch.
R2_SCOPES = ("serve", "core", "data", "launch")

# R6 applies where the streaming and serving state updates live.
R6_SCOPES = ("core", "serve")
# first-parameter names marking a state update: `state` for
# SkylineState / WindowedSkylineState updates, `leaves` for slab-arena
# updates (SlabArena.leaves()).
STATE_OPERANDS = ("state", "leaves")

# R4: the one module allowed to touch torch.distributed: the meshes,
# the process groups and the collectives the census records.
COMPAT_MODULE = "repro_torch.launch.mesh"
