"""StarCoder2-7B: dense GQA, RoPE, GELU MLP [arXiv:2402.19173; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense", n_layers=32, d_model=4608,
    n_heads=36, n_kv_heads=4, d_ff=18432, vocab=49152, mlp_kind="gelu",
    rope_theta=1e5, microbatches=8)

SMOKE = ModelConfig(
    name="starcoder2-7b-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, mlp_kind="gelu")
