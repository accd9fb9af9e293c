"""Yi-6B: llama-arch dense GQA [arXiv:2403.04652; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=4, d_ff=11008, vocab=64000, rope_theta=5e6,
    microbatches=8)

SMOKE = ModelConfig(
    name="yi-6b-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, rope_theta=5e6)
