"""Training: AdamW with its schedule, clipping and int8 compression
(`repro_torch.train.optim`), the microbatched train step
(`repro_torch.train.step`) and GPipe over a stage group of ranks
(`repro_torch.train.pipeline`).  Plain torch: a training step launches
no kernel of the port."""
