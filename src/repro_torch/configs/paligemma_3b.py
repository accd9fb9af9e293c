"""PaliGemma-3B: SigLIP vision stub + gemma decoder, prefix-LM
[arXiv:2407.07726; hf]. input_specs() provides precomputed 1152-d SigLIP
patch embeddings (256 patches)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm", n_layers=18, d_model=2048,
    n_heads=8, n_kv_heads=1, d_ff=16384, vocab=257216, head_dim=256,
    mlp_kind="geglu", frontend_dim=1152, prefix_len=256, microbatches=4)

SMOKE = ModelConfig(
    name="paligemma-3b-smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=1, d_ff=128, vocab=256, head_dim=16,
    mlp_kind="geglu", frontend_dim=32, prefix_len=8)
