"""Checkpoints that either package reads (`repro_torch.checkpoint.manager`)."""
