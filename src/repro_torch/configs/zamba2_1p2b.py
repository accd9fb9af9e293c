"""Zamba2-1.2B: Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf]. 38 mamba2 layers; the shared attn+MLP block is
applied before every 6th layer (7 applications)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32000, head_dim=64,
    ssm_state=64, ssm_heads=64, ssm_head_dim=64, attn_every=6,
    microbatches=8)

SMOKE = ModelConfig(
    name="zamba2-1.2b-smoke", family="hybrid", n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=256, head_dim=16,
    ssm_state=16, ssm_heads=4, ssm_head_dim=16, ssm_chunk=8, attn_every=2)
