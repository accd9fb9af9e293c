"""Launch-side helpers of the port: the program suite
(`repro_torch.launch.cells`) that the verifier runs."""
