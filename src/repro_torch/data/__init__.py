"""Data-side users of the skyline: curation by Pareto front
(`repro_torch.data.selection`) and the synthetic input pipeline
(`repro_torch.data.pipeline`)."""
