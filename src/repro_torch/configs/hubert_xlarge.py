"""HuBERT-XLarge: encoder-only audio transformer [arXiv:2106.07447;
unverified]. Modality frontend is a stub: input_specs() provides
precomputed 512-d conv-frontend frame embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, d_ff=5120, vocab=504, head_dim=80,
    mlp_kind="gelu", frontend_dim=512, tie_embeddings=False,
    microbatches=4)

SMOKE = ModelConfig(
    name="hubert-xlarge-smoke", family="encoder", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=64, head_dim=16,
    mlp_kind="gelu", frontend_dim=16, tie_embeddings=False)
