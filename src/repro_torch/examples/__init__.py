"""The port's twins of the repository's example drivers (``examples/``).

Each module does what its reference example does and prints the same
lines, on the card unless given ``--device cpu`` (without CUDA it raises
``RuntimeError``).  Run one as ``python -m repro_torch.examples.<name>``:

  quickstart               sequential SFS, then `parallel_skyline` under
                           each strategy and NoSeq
  distributed_skyline      the sliced strategy on a world of W ranks
  serving_pareto           the engine's batched views, the serve loop,
                           admission, and greedy decode on a smoke MoE
  streaming_pareto         device-resident streams, a sliding window,
                           slab arenas, streaming admission
  train_skyline_curation   language-model training whose every batch is
                           picked Pareto-front first by the dominance
                           kernel

Besides ``--device`` each takes only its reference's options and the
sizes to which its data and steps may be cut.  The reference draws its
points from ``jax.random``, which torch cannot reproduce, so the sizes
they print differ; the token batches of the training driver are the
reference's bit for bit (``data.pipeline``).
"""
