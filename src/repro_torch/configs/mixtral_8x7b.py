"""Mixtral-8x7B: 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=32000, n_experts=8,
    top_k=2, attn_kind="window", window=4096, rope_theta=1e6,
    param_dtype="bfloat16", microbatches=8)  # bf16: 47B f32 params+grads
    # alone exceed 16 GB/chip at TP-16 (DESIGN.md §6, as llama4)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, n_experts=4, top_k=2,
    attn_kind="window", window=16)
