"""Llama-4-Maverick 400B-A17B: MoE 128e top-1 (every 2nd layer) + shared
expert; iRoPE interleaved attention (3 chunked-local + 1 global NoPE)
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

param_dtype=bfloat16: 400B params with f32 master + f32 Adam moments need
~6.4 TB > the 4 TB of a 256-chip v5e pod; bf16 params/moments fit
(DESIGN.md §6). Real runs use larger meshes or fp8."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48,
    d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048,
    head_dim=128, n_experts=128, top_k=1, moe_every=2, shared_expert=True,
    attn_kind="chunk", chunk=8192, global_every=4, rope_theta=5e5,
    param_dtype="bfloat16", microbatches=32)

SMOKE = ModelConfig(
    name="llama4-maverick-smoke", family="moe", n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
    n_experts=4, top_k=1, moe_every=2, shared_expert=True,
    attn_kind="chunk", chunk=16, global_every=4)
