"""Input pipeline: a deterministic synthetic corpus with a cursor that a
checkpoint saves.

Counterpart of ``repro.data.pipeline``, bit for bit: each batch is drawn
with numpy from ``SeedSequence([seed, shard_id, step])``, so a restart
from a saved cursor, or another data shard, gets its own stream and the
same bits as the reference.  Batches are {"tokens": (B, S) int32,
"labels": (B, S) int32} with the labels shifted by one; the ``encoder``
family gets {"frames": (B, S, frontend_dim) f32, "labels"} and the
``vlm`` family an ``image_emb`` prefix of ``prefix_len`` rows besides its
text.  ``cfg`` is any object with ``family``, ``vocab``,
``frontend_dim`` and ``prefix_len``.

The arrays become tensors on ``device``: the card unless ``"cpu"`` is
given.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device

__all__ = ["DataState", "make_batch", "next_batch"]


@dataclasses.dataclass(frozen=True)
class DataState:
    seed: int
    step: int

    def advance(self):
        return DataState(self.seed, self.step + 1)


def _tokens(rng: np.random.Generator, b: int, s: int, vocab: int):
    """Markov-ish synthetic text: a random walk over token ids with
    occasional jumps, so a language model has local structure to
    learn."""
    base = rng.integers(0, vocab, size=(b, 1))
    steps = rng.integers(-8, 9, size=(b, s))
    jumps = rng.random((b, s)) < 0.05
    steps = np.where(jumps, rng.integers(0, vocab, size=(b, s)), steps)
    toks = (np.cumsum(np.concatenate([base, steps[:, :-1]], 1), 1)
            % vocab).astype(np.int32)
    return toks


def _arrays(cfg, b: int, s: int, state: DataState,
            shard_id: int) -> dict[str, np.ndarray]:
    """The batch as numpy arrays, drawn as the reference draws them."""
    rng = np.random.default_rng(
        np.random.SeedSequence([state.seed, shard_id, state.step]))
    if cfg.family == "encoder":
        frames = rng.standard_normal((b, s, cfg.frontend_dim),
                                     dtype=np.float32)
        labels = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
        return {"frames": frames, "labels": labels}
    if cfg.family == "vlm":
        s_text = s - cfg.prefix_len
        img = rng.standard_normal((b, cfg.prefix_len, cfg.frontend_dim),
                                  dtype=np.float32)
        toks = _tokens(rng, b, s_text + 1, cfg.vocab)
        return {"image_emb": img, "tokens": toks[:, :-1],
                "labels": toks[:, 1:]}
    toks = _tokens(rng, b, s + 1, cfg.vocab)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batch(cfg, b: int, s: int, state: DataState, shard_id: int = 0,
               *, device=None) -> dict[str, torch.Tensor]:
    """One batch of ``b`` sequences of ``s`` positions at the cursor
    ``state`` for data shard ``shard_id``, as tensors on ``device``."""
    dev = resolve_device(device)
    arrays = _arrays(cfg, b, s, state, shard_id)
    # one host buffer, one copy to the device, then views per key
    flat = np.concatenate([a.reshape(-1).view(np.uint8)
                           for a in arrays.values()])
    moved = torch.from_numpy(flat).to(dev)
    out, at = {}, 0
    for key, a in arrays.items():
        n = a.nbytes
        dtype = torch.float32 if a.dtype == np.float32 else torch.int32
        out[key] = moved[at:at + n].view(dtype).view(a.shape)
        at += n
    return out


def next_batch(cfg, b: int, s: int, state: DataState, shard_id: int = 0,
               *, device=None):
    return make_batch(cfg, b, s, state, shard_id, device=device), \
        state.advance()
