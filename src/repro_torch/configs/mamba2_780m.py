"""Mamba2-780m: pure SSM (SSD) [arXiv:2405.21060; unverified].
d_inner = 2*d_model = 3072 -> 48 heads x 64."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab=50280, ssm_state=128,
    ssm_heads=48, ssm_head_dim=64, ssm_chunk=256, microbatches=2)

SMOKE = ModelConfig(
    name="mamba2-780m-smoke", family="ssm", n_layers=2, d_model=64,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab=256, ssm_state=16,
    ssm_heads=4, ssm_head_dim=16, ssm_chunk=8)
