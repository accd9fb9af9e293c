"""Shape grid, applicability rules, and per-arch sharding-rule derivation.

Shapes (assignment): train_4k / prefill_32k / decode_32k / long_500k.
``decode_*``/``long_*`` lower serve_step (one token against a KV cache of
seq_len), not train_step. Counterpart of ``repro.configs.base``,
rule for rule. Skips (DESIGN.md §Arch-applicability): pure
full-attention archs skip long_500k; encoder-only archs skip decode shapes.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.common import DEFAULT_RULES
from repro_torch.models.config import ModelConfig

__all__ = ["SHAPES", "applicable_shapes", "skip_reason", "arch_rules",
           "ShapeSpec"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def _sub_quadratic(cfg: ModelConfig) -> bool:
    """Can this arch decode at 500k without a full quadratic KV cache?
    SSM/hybrid: constant state (+ seq-sharded shared-attn KV). SWA /
    chunked-local attention: bounded KV (llama4's global-NoPE layers keep a
    full but seq-shardable cache — iRoPE's long-context design)."""
    if cfg.family in ("ssm", "hybrid"):
        return True
    if cfg.attn_kind in ("window", "chunk"):
        return True
    if cfg.global_every:  # iRoPE mix
        return True
    return False


def skip_reason(cfg: ModelConfig, shape: str) -> str | None:
    spec = SHAPES[shape]
    if cfg.family == "encoder" and spec.kind == "decode":
        return "encoder-only: no decode step"
    if shape == "long_500k" and not _sub_quadratic(cfg):
        return "pure full-attention arch: long_500k needs sub-quadratic attention"
    return None


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    return [s for s in SHAPES if skip_reason(cfg, s) is None]


def arch_rules(cfg: ModelConfig, shape: str, *, model_axis: int = 16,
               data_axis: int = 16, multi_pod: bool = False) -> dict:
    """Derive logical-axis rules for (arch x shape) with divisibility
    fallbacks (DESIGN.md §6). This is the baseline; §Perf hillclimbs
    override individual entries."""
    rules = dict(DEFAULT_RULES)
    spec = SHAPES[shape]

    def div(n, ax):  # can dim of size n shard over axis ax?
        return n > 0 and n % ax == 0

    # tensor-parallel fallbacks; when attention heads cannot shard over
    # the model axis, fall back to sequence-parallel attention (the
    # quadratic (Sq, Sk) intermediates shard over q-seq instead)
    heads = cfg.ssm_heads if cfg.family in ("ssm",) else cfg.n_heads
    if not div(heads, model_axis):
        rules["heads"] = None
        # shard the attention *weights* on head_dim instead (otherwise
        # L x (wq + wo) would be fully replicated — GiBs at 14B scale)
        if div(cfg.head_dim_eff, model_axis):
            rules["head_dim"] = "model"
        if spec.kind in ("train", "prefill") and \
                spec.seq_len % model_axis == 0:
            rules["attn_seq"] = "model"
            # Megatron-SP residual stream: keep x sequence-sharded
            # BETWEEN blocks too, so each block is all-gather(x) in,
            # reduce-scatter(y) out (bf16), instead of re-replicating
            # the f32 residual/grad per layer (§Perf hillclimb 1b)
            rules["seq"] = "model"
    if not div(cfg.n_kv_heads, model_axis):
        rules["kv_heads"] = None
    if cfg.d_ff and not div(cfg.d_ff, model_axis):
        rules["mlp"] = None
    if cfg.n_experts:
        if div(cfg.n_experts, model_axis):
            # 2-D expert sharding: experts over model x expert-hidden over
            # data — weights stay resident, the inter-einsum partial sums
            # travel (generic weight-FSDP was tried and refuted: per-
            # microbatch weight gathers cost 293 s collective on mixtral)
            rules["expert"] = "model"
            # 2nd weight dim over data via expert_embed (expert_mlp over
            # data would collide with the token-sharded dispatch buffer)
            if div(cfg.d_model, data_axis):
                rules["expert_embed"] = "data"
        else:
            rules["expert"], rules["expert_mlp"] = None, "model"
            # few big experts (mixtral): TP over model + FSDP the expert
            # weights' embed dim over data (params dominate per-chip
            # memory; the per-layer weight gather is ~60 MB/mat)
            if div(cfg.d_model, data_axis):
                rules["expert_embed"] = "data"

    # batch / sequence shardings per shape
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    total_batch_shards = data_axis * (2 if multi_pod else 1)
    if not div(spec.global_batch, total_batch_shards):
        if div(spec.global_batch, data_axis):
            rules["batch"] = ("data",)
        else:
            rules["batch"] = None
    else:
        rules["batch"] = batch_axes

    if spec.kind == "prefill":
        # the produced KV caches dominate prefill memory: shard their
        # sequence dim over the model axis (kv_heads then stays
        # replicated on the cache to avoid same-axis-twice specs)
        rules["kv_heads"] = None
        rules["kv_seq"] = "model"
    if spec.kind == "decode":
        # KV cache is the dominant buffer: shard its sequence dim. The
        # mesh "model" axis then carries the cache, so kv_heads must stay
        # replicated on the cache (same-axis-twice is invalid SPMD), and
        # q-heads must NOT shard over model either: a heads-sharded q
        # against a seq-sharded cache makes GSPMD all-gather the cache
        # every layer (measured: 34 GB/chip wire on yi-6b). Per-token
        # tensors are tiny - replicate them, shard the weights on
        # head_dim instead.
        rules["kv_heads"] = None
        rules["heads"] = None
        if div(cfg.head_dim_eff, model_axis):
            rules["head_dim"] = "model"
        if cfg.n_experts and rules.get("expert") == "model":
            # serving: expert weights must be resident — the train-time
            # expert_embed/data (FSDP) dim would be all-gathered per
            # decoded token (measured 97 GB/chip on llama4); shard the
            # expert hidden dim over data instead (§Perf hillclimb 4)
            rules["expert_embed"] = None
            rules["expert_mlp"] = ("data" if div(cfg.d_ff, data_axis)
                                   else None)
        if spec.global_batch == 1:
            # long-context: context parallelism — the paper's SLICED idea
            # applied to the KV sequence (DESIGN.md §6)
            rules["batch"] = None
            rules["kv_seq"] = ("data", "model")
        else:
            rules["kv_seq"] = "model"
    return rules
