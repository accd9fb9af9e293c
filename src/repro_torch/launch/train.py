"""End-to-end training driver with checkpoint/restart fault tolerance.

Counterpart of ``repro.launch.train``, with its flags and defaults, plus
``--device`` (default: the card; ``cpu`` runs there).  ``--smoke`` takes
the reduced configs; the full configs train at their published widths
on the card as far as its memory holds them.

  python -m repro_torch.launch.train --arch yi-6b --smoke \\
      --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Fault tolerance: every step runs under a retry guard: on failure the
loop restores the last checkpoint (atomic on disk) and replays from
there.  ``--fail-at N`` injects a one-shot failure for testing.

The parameters come from ``init_params(seed=seed)`` on the device, the
batches from ``data.pipeline.next_batch`` (the reference's bits), and
the state is written in place by each step (the reference donates it).
Losses are read to the host only at ``log_every``.  When the last
periodic checkpoint is the last step, it is not written a second time
(the reference writes the same files again).
"""

from __future__ import annotations

import argparse
import math
import time

from repro_torch.checkpoint.manager import CheckpointManager, latest_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataState, next_batch
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import init_params
from repro_torch.train.optim import OptConfig
from repro_torch.train.step import init_state, make_train_step

__all__ = ["train_loop", "main"]


def train_loop(cfg, *, steps: int, batch: int, seq: int, ckpt_dir=None,
               ckpt_every: int = 50, opt_cfg: OptConfig | None = None,
               seed: int = 0, fail_at: int | None = None,
               log_every: int = 10, resume: bool = True, device=None):
    """Train ``steps`` steps on ``device`` (the card unless ``"cpu"``);
    returns ``(state, history)`` with history ``[(step, loss)]`` at the
    logged steps."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or OptConfig(total_steps=steps)
    params = init_params(T.lm_plan(cfg), seed=seed, device=dev)
    state = init_state(params, opt_cfg)
    data = DataState(seed=seed + 1, step=0)
    start = 0

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and resume and latest_step(ckpt_dir) is not None:
        state, start, extra = mgr.restore(state)
        data = DataState(seed=extra.get("data_seed", seed + 1),
                         step=extra.get("data_step", start))
        print(f"[train] resumed from step {start}")

    step_fn = make_train_step(cfg, opt_cfg)
    history = []
    injected = {"done": fail_at is None}
    saved = None        # the step of the last checkpoint written

    i = start
    while i < steps:
        try:
            b, data_next = next_batch(cfg, batch, seq, data, device=dev)
            if not injected["done"] and i == fail_at:
                injected["done"] = True
                raise RuntimeError("injected failure (test)")
            state, metrics = step_fn(state, b)
            data = data_next
            if (i + 1) % log_every == 0 or i == start:
                loss = float(metrics["loss"])
                history.append((i + 1, loss))
                print(f"[train] step {i + 1:5d} loss={loss:.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"gnorm={float(metrics['grad_norm']):.3f}")
            if mgr and (i + 1) % ckpt_every == 0:
                mgr.save(i + 1, state, {"data_seed": data.seed,
                                        "data_step": data.step})
                saved = i + 1
            i += 1
        except Exception as e:  # noqa: BLE001 — the fault-tolerance path
            if mgr is None or latest_step(mgr.dir) is None:
                raise
            print(f"[train] step {i} failed ({e}); restoring last "
                  "checkpoint and replaying")
            state, i, extra = mgr.restore(state)
            data = DataState(seed=extra["data_seed"],
                             step=extra["data_step"])
    if mgr:
        # the reference saves the last step again; the files would be
        # the same ones
        if saved != steps:
            mgr.save(steps, state, {"data_seed": data.seed,
                                    "data_step": data.step})
        mgr.wait()
    return state, history


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="where to train (default: the card; 'cpu' runs "
                         "on the CPU)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    t0 = time.time()
    state, history = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        opt_cfg=OptConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 1)),
        fail_at=args.fail_at, device=args.device)
    dt = time.time() - t0
    losses = [l for _, l in history]
    print(f"[train] done {args.steps} steps in {dt:.1f}s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert math.isfinite(losses[-1])
    return state, history


if __name__ == "__main__":
    main()
