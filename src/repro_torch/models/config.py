"""Model configuration dataclass shared by the model zoo and configs/.

Counterpart of ``repro.models.config``, field for field: the same
fields, defaults and derived counts (``head_dim_eff``,
``vocab_padded``, ``d_inner``, ``n_attn_apps``, ``sub_pattern``,
``param_count``, ``active_param_count``), so a config converts across
with ``dataclasses.asdict`` (`repro_torch.convert.model_config_from_reference`).

The execution fields were written for XLA; in eager torch they mean:

* ``remat`` matters only under autograd: a forward that builds a graph
  (training) runs each block under ``torch.utils.checkpoint``, so its
  activations are recomputed in the backward pass; prefill, decode and
  ``torch.no_grad`` calls ignore it.
* ``scan_layers`` and ``scan_unroll`` select how XLA compiles the loop
  over the stacked layer axis.  Here that loop is a Python loop over the
  leading layer axis of the parameters; the math is the same either way.
* ``param_dtype`` is read only by the dry run and the parameter specs
  (ROADMAP item 14c); ``init_params`` makes every leaf in its plan dtype
  (f32) unless asked for another.
* ``compute_dtype`` is the dtype of the matrix products, as in the
  reference; norms, softmax and the loss stay f32.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # attention flavour
    qk_norm: bool = False
    rope_theta: float = 1e4
    attn_kind: str = "causal"   # causal | window | chunk | bidir | prefix
    window: int = 0             # sliding-window size (attn_kind="window")
    chunk: int = 0              # local-chunk size (attn_kind="chunk")
    global_every: int = 0       # llama4 iRoPE: every k-th layer global NoPE
    mlp_kind: str = "swiglu"    # swiglu | gelu

    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1          # MoE every k-th layer (llama4: 2)
    shared_expert: bool = False
    capacity_factor: float = 1.25

    # ssm / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0          # d_inner = ssm_heads * ssm_head_dim
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0         # hybrid: shared attn before layers i%k==0

    # modality frontend stubs (audio/vlm)
    frontend_dim: int = 0       # >0: inputs are precomputed embeddings
    prefix_len: int = 0         # vlm: number of image-prefix tokens

    # execution
    tie_embeddings: bool = True
    remat: bool = True
    scan_layers: bool = True
    scan_unroll: bool = False   # dry-run cost probes: fully unroll scans
    blockwise_threshold: int = 8192
    attn_block_k: int = 1024
    param_dtype: str = "float32"     # llama4: bfloat16 (DESIGN.md §6)
    compute_dtype: str = "bfloat16"
    microbatches: int = 1            # grad-accumulation steps per train step

    # ---- derived ----
    @property
    def head_dim_eff(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_heads * self.ssm_head_dim

    @property
    def n_attn_apps(self) -> int:
        """Hybrid: number of shared-attention applications."""
        if not self.attn_every:
            return 0
        return -(-self.n_layers // self.attn_every)

    def sub_pattern(self):
        """llama4 super-layer: per-sub (attn_is_global, ffn_is_moe)."""
        period = self.global_every or 1
        return [((i + 1) % (self.global_every or 10 ** 9) == 0,
                 self.n_experts > 0 and (i + 1) % self.moe_every == 0)
                for i in range(period)]

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline MODEL_FLOPS)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_padded
        hq, hk, dh = self.n_heads, self.n_kv_heads, self.head_dim_eff
        attn = d * dh * (hq + 2 * hk) + hq * dh * d
        mlp = d * f * (3 if self.mlp_kind == "swiglu" else 2)
        moe = 0
        if self.n_experts:
            moe = self.n_experts * 3 * d * f + d * self.n_experts
            if self.shared_expert:
                moe += 3 * d * f
        ssm = 0
        if self.ssm_heads:
            h, p, n = self.ssm_heads, self.ssm_head_dim, self.ssm_state
            ssm = d * h * p * 2 + 2 * d * n + d * h + h * p * d
        total = v * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "encoder", "vlm"):
            total += self.n_layers * (attn + mlp)
        elif self.family == "moe":
            n_moe = self.n_layers // self.moe_every
            total += self.n_layers * attn + n_moe * moe \
                + (self.n_layers - n_moe) * mlp
        elif self.family == "ssm":
            total += self.n_layers * ssm
        elif self.family == "hybrid":
            total += self.n_layers * ssm + (attn + mlp)  # one shared block
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k only)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_like = self.param_count()
        n_moe = self.n_layers // self.moe_every
        all_experts = n_moe * self.n_experts * 3 * d * f
        active = n_moe * self.top_k * 3 * d * f
        return dense_like - all_experts + active
