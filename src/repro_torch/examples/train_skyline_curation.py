"""End-to-end training driver: LM training with skyline (Pareto-front)
batch curation, the paper's technique as the data-selection layer.

Counterpart of ``examples/train_skyline_curation.py``.  Every step draws
a 2x-oversized candidate batch, scores each example on three criteria
(hardness = -loss, brevity penalty, staleness), and keeps a batch built
Pareto-front-first via the skyline: one launch of the dominance kernel
(`repro_torch.data.selection.pareto_select`) on the card.  The model is
the port's own transformer stack.

  python -m repro_torch.examples.train_skyline_curation           # ~15M
  python -m repro_torch.examples.train_skyline_curation --model-100m
  python -m repro_torch.examples.train_skyline_curation --device cpu

It runs on the card unless given ``--device cpu``.  The batches are the
reference's bit for bit (``data.pipeline``); the parameters come from
``init_params(seed=0)``, and each train step writes the state in place
(the reference donates it).  `train` is the loop; `main` prints from it
the reference's lines and keeps its closing assertion, which compares
two single-step losses.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.data.pipeline import DataState, make_batch
from repro_torch.data.selection import pareto_select
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.train.optim import OptConfig
from repro_torch.train.step import init_state, make_train_step

__all__ = ["model_config", "per_example_loss", "opt_config", "train",
           "CurationRun", "main"]

PHASES = ("candidates", "select", "step")


def model_config(big: bool) -> ModelConfig:
    if big:  # ~100M params
        return ModelConfig(name="lm-100m", family="dense", n_layers=10,
                           d_model=640, n_heads=10, n_kv_heads=5,
                           d_ff=2560, vocab=16384, microbatches=1)
    return ModelConfig(name="lm-15m", family="dense", n_layers=6,
                       d_model=320, n_heads=8, n_kv_heads=4, d_ff=1280,
                       vocab=8192, microbatches=1)


def per_example_loss(params, cfg, batch) -> torch.Tensor:
    """(B,) f32: the logsumexp over the (padded) vocabulary minus the
    label's logit, averaged over the sequence.  A label of -1 takes no
    logit, as the reference's one-hot row of zeros."""
    logits, _, _ = T.forward(params, cfg, batch)
    labels = batch["labels"].long()
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    nll = lse - torch.where(labels >= 0, picked, torch.zeros_like(picked))
    return torch.mean(nll, dim=-1)


def opt_config(steps: int) -> OptConfig:
    """The example's schedule: lr 1e-3, a warm-up of a twentieth of the
    steps, cosine decay to the last."""
    return OptConfig(lr=1e-3, total_steps=steps,
                     warmup_steps=max(steps // 20, 1))


class CurationRun(NamedTuple):
    """What `train` returns.  ``indices[i]`` is step i's own selection
    ((batch,) int32 on the device; None without curation), ``criteria``
    and ``fronts`` the (2·batch, 3) criteria and the front mask it was
    picked from, ``phase_ms`` the milliseconds spent over all steps in
    each of `PHASES` (CUDA events on the card, the host clock on the
    CPU)."""
    losses: list
    indices: list
    state: dict
    criteria: list
    fronts: list
    phase_ms: dict


class _Marks:
    """Points on the device's timeline (CUDA events) or the host's."""

    def __init__(self, dev: torch.device):
        self.stream = (torch.cuda.current_stream(dev)
                       if dev.type == "cuda" else None)
        self.marks: list = []

    def mark(self) -> None:
        if self.stream is None:
            self.marks.append(time.perf_counter())
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        self.marks.append(ev)

    def ms(self, a: int, b: int) -> float:
        if self.stream is None:
            return (self.marks[b] - self.marks[a]) * 1e3
        return self.marks[a].elapsed_time(self.marks[b])


def train(cfg, *, steps: int, batch: int, seq: int, curate: bool = True,
        device=None, impl: str = "auto", replay=None,
        log_every: int = 0) -> CurationRun:
    """Train ``steps`` steps of ``batch`` sequences of ``seq`` tokens on
    ``device`` (the card unless ``"cpu"``).  With ``curate`` each batch
    is picked from ``2·batch`` candidates by `pareto_select` (``impl``
    its dominance backend); ``replay[i]``, when given, is used as step
    i's indices in place of the selection, which is still made and
    returned.  ``log_every`` > 0 prints the reference's progress line
    every that many steps."""
    dev = resolve_device(device)
    opt = opt_config(steps)
    state = init_state(init_params(T.lm_plan(cfg), seed=0, device=dev),
                       opt)
    step_fn = make_train_step(cfg, opt)
    data = DataState(seed=1, step=0)
    recency = torch.arange(batch * 2, dtype=torch.float32, device=dev)
    marks = _Marks(dev)
    losses, indices, criteria, fronts = [], [], [], []
    t0 = time.time()
    for i in range(steps):
        marks.mark()
        if curate:
            # oversample 2x, keep the Pareto-front-first half
            cand = make_batch(cfg, batch * 2, seq, data, device=dev)
            data = data.advance()
            with torch.no_grad():
                loss_c = per_example_loss(state["params"], cfg, cand)
            lengths = torch.sum(cand["labels"] >= 0, dim=-1)
            crit = torch.stack([-loss_c, -lengths.float(), recency], dim=-1)
            marks.mark()
            idx, front = pareto_select(crit, batch, device=dev, impl=impl)
            use = idx if replay is None else torch.from_numpy(
                np.array(replay[i])).to(dev)
            chosen = {k: v[use.long()] for k, v in cand.items()}
            indices.append(idx)
            criteria.append(crit)
            fronts.append(front)
        else:
            chosen = make_batch(cfg, batch, seq, data, device=dev)
            data = data.advance()
            marks.mark()
            indices.append(None)
        marks.mark()
        state, metrics = step_fn(state, chosen)
        losses.append(metrics["loss"])
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1:4d} loss={float(metrics['loss']):.4f} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)")
    marks.mark()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    phase_ms = dict.fromkeys(PHASES, 0.0)
    for i in range(steps):
        at = 3 * i
        for k, name in enumerate(PHASES):
            phase_ms[name] += marks.ms(at + k, at + k + 1)
    host = torch.stack(losses).tolist() if losses else []
    return CurationRun(host, indices, state, criteria, fronts, phase_ms)


def main(argv=None) -> CurationRun:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.train_skyline_curation")
    ap.add_argument("--model-100m", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--curate", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default=None,
                    help="where to train (default: the card; 'cpu' runs "
                         "on the CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = model_config(args.model_100m)
    print(f"model: {cfg.name} ({cfg.param_count() / 1e6:.1f}M params), "
          f"curation={'on' if args.curate else 'off'}")
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
              curate=args.curate, device=dev, log_every=25)
    first, last = out.losses[0], out.losses[-1]
    print(f"loss {first:.4f} -> {last:.4f} over {args.steps} steps")
    assert np.isfinite(last) and last < first
    return out


if __name__ == "__main__":
    main()
