"""GPipe-style pipeline parallelism over a stage group of ranks.

Counterpart of ``repro.train.pipeline``.  Each rank (stage) runs one
segment of the layer stack; microbatches stream through an
(n_micro + n_stages - 1)-tick schedule, each tick passing the stage's
activations to the next stage.  The bubble fraction is the standard
(S-1)/(M+S-1).  Forward only, as in the reference.

The reference runs inside ``shard_map`` over a ``stage`` mesh axis.  The
port runs one process per stage (`repro_torch.launch.mesh`): the
stages are the workers axis of a 1-D `WorkerMesh` (``make_worker_mesh
(S)``), and, as for every entry point given a mesh, each rank calls
`gpipe_forward` with the same whole inputs and gets the whole answer:

* the stacked ``(S, L/S, ...)`` parameter tree of `pipeline_stages`,
  of which stage i runs block i (the reference's ``P("stage")``);
* each tick's ``ppermute`` of the pairs (i -> i+1) is `WorkerMesh.shift`:
  point-to-point send and receive down the chain, through the census's
  ``collective_call``;
* the reference ends with a float ``psum`` of the outputs, which only
  the last stage fills.  The port broadcasts the last stage's outputs
  (bit for bit, `WorkerMesh.broadcast_from_root`) and, with two stages
  or more, adds +0.0: the psum adds the other stages' zeros, which is
  exact for every value and turns -0.0 into +0.0, and the addition does
  the same.  With one stage XLA's psum is a copy and keeps -0.0, and so
  does the port.
"""

from __future__ import annotations

import torch

from repro_torch.models.transformer import tree_map

__all__ = ["gpipe_forward", "pipeline_stages"]


def pipeline_stages(params_stacked, n_stages: int):
    """Split an (L, ...)-stacked layer tree into (n_stages, L/S, ...)."""
    def f(x):
        n = x.shape[0]
        assert n % n_stages == 0, (n, n_stages)
        return x.reshape(n_stages, n // n_stages, *x.shape[1:])
    return tree_map(f, params_stacked)


def gpipe_forward(stage_fn, params_stages, micro_inputs: torch.Tensor, *,
                  mesh) -> torch.Tensor:
    """Run the pipeline on this rank, stage ``mesh.w_index`` of
    ``mesh.workers``.

    Args:
      stage_fn: (stage_params, x) -> y, one pipeline stage.
      params_stages: the (n_stages, ...) stacked tree of
        `pipeline_stages`; this stage runs its block.
      micro_inputs: (n_micro, B, ...) microbatched inputs (the same on
        every stage; only stage 0 reads them).
      mesh: a `WorkerMesh` whose workers are the stages.

    Returns:
      (n_micro, B, ...) outputs, the same on every stage.
    """
    mesh.check_member()
    n_stages, sidx = mesh.workers, mesh.w_index
    n_micro = micro_inputs.shape[0]
    params_local = tree_map(lambda p: p[sidx], params_stages)

    recv = torch.zeros_like(micro_inputs[0])
    outs = torch.zeros_like(micro_inputs)
    for t in range(n_micro + n_stages - 1):
        x_in = micro_inputs[min(t, n_micro - 1)] if sidx == 0 else recv
        y = stage_fn(params_local, x_in)
        # emit on the last stage when microbatch t-(S-1) completes
        out_idx = t - (n_stages - 1)
        if sidx == n_stages - 1 and out_idx >= 0:
            outs[out_idx] = y
        recv = mesh.shift(y)
    outs = mesh.broadcast_from_root(outs, root=n_stages - 1)
    return outs + 0.0 if n_stages > 1 else outs
