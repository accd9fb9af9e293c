"""Phi-4-mini 3.8B: dense GQA, RoPE + SwiGLU [arXiv:2412.08905; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, d_ff=8192, vocab=200064, microbatches=4)

SMOKE = ModelConfig(
    name="phi4-mini-3.8b-smoke", family="dense", n_layers=2, d_model=48,
    n_heads=4, n_kv_heads=2, d_ff=96, vocab=256)
