"""Model configuration: the port's own copy of the reference's
``ModelConfig`` (a pure dataclass, so it is copied, not imported).

A model is ``prefix`` layers followed by ``n_blocks`` repeats of a ``block``
pattern. Only the fields the port reads are copied, the training-policy
hints included (``router_aux_weight``, ``opt_state_dtype``, ``remat``,
``remat_policy``) and the four mesh-sharding knobs
(``activation_partitioning`` and the ``*_weight_shard`` fields), each with
the reference's default. MoE routing (``top_k``, ``capacity_factor``), a
cross-attention model's image tokens (``n_img_tokens``) and its tanh gate
(``cross_attn_gated``) and MLA's widths (``q_lora_rank``, ``kv_lora_rank``,
``qk_rope_dim``, ``qk_nope_dim``, ``v_head_dim``; deepseek-v2-236b) are here.
"""
from __future__ import annotations

import dataclasses

# where the parts of the reference the port does not run yet are queued
LATER_ITEM = "ROADMAP Queue 1"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str  # "attn" | "mamba" | "cross_attn"
    ffn: str  # "dense" | "moe" | "moe_dense" (arctic parallel residual) | "none"
    window: int | None = None  # sliding-window size for this layer's attention


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    vocab_size: int
    # ---- stack structure
    prefix: tuple[LayerSpec, ...] = ()
    block: tuple[LayerSpec, ...] = (LayerSpec("attn", "dense"),)
    n_blocks: int = 1
    # ---- attention
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int | None = None
    qk_norm: bool = False
    rope_theta: float = 1e4
    causal: bool = True  # False => encoder-only (no decode shapes)
    # ---- MLA (deepseek-v2)
    use_mla: bool = False
    q_lora_rank: int | None = None
    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128
    # ---- FFN
    d_ff: int = 0
    activation: str = "swiglu"  # swiglu | gelu | sq_relu
    # ---- MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # ---- mamba
    ssm_state: int = 16
    d_conv: int = 4
    mamba_expand: int = 2
    # ---- frontends
    frontend: str = "tokens"  # tokens | frames (audio stub) | tokens+image (vlm)
    n_img_tokens: int = 0
    cross_attn_gated: bool = True
    # ---- misc
    embed_scale: bool = False  # gemma-style sqrt(d) embedding multiplier
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # training-policy hints consumed by launch/train
    opt_state_dtype: str = "float32"  # "bfloat16" for the giant MoEs
    remat: bool = True
    # ---- mesh placement (the reference's knobs and defaults)
    # "batch": activations shard the batch over the data axes only; "seq":
    # they also shard the sequence over the model axis (on a model axis of 1
    # the two are one)
    activation_partitioning: str = "batch"
    # MoE expert weights: "d" = FSDP on d_model, gathered per layer (train);
    # "f" = the hidden dim sharded over the data axes, weights never move,
    # partial outputs summed (moe_ffn_fshard, decode and train)
    moe_weight_shard: str = "d"
    # dense-FFN weights: "d" as above; "f" = hidden dim over every axis
    dense_weight_shard: str = "d"
    # attention projections: the same "d"/"f" convention (GQA only)
    attn_weight_shard: str = "d"
    # remat policy: "dots" (save matmul outputs), "nothing", or "save_moe"
    # (keep the MoE layers' outputs across the backward pass)
    remat_policy: str = "dots"

    # ------------------------------------------------------------ derived
    @property
    def head_dim(self) -> int:
        if self.use_mla:
            return self.qk_nope_dim + self.qk_rope_dim
        if self.d_head is not None:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def num_layers(self) -> int:
        return len(self.prefix) + self.n_blocks * len(self.block)

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def supports_long_context(self) -> bool:
        """True when at most a quarter of the layers (at least one) keep a
        full-attention KV cache: SSM, hybrid and sliding-window families may
        run ``long_500k``; pure full-attention ones skip it (the
        reference's rule)."""
        specs = self.layers()
        full_attn = [s for s in specs if s.mixer == "attn" and s.window is None]
        return len(full_attn) <= max(1, len(specs) // 4)

    def layers(self) -> list[LayerSpec]:
        return list(self.prefix) + list(self.block) * self.n_blocks

    def param_count(self) -> int:
        """Analytic parameter count (the reference's formula)."""
        d = self.d_model
        total = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d
        dh = self.head_dim
        for spec in self.layers():
            if spec.mixer == "attn" or spec.mixer == "cross_attn":
                if self.use_mla:
                    qin = self.q_lora_rank or d
                    if self.q_lora_rank:
                        total += d * self.q_lora_rank
                    total += qin * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    total += d * (self.kv_lora_rank + self.qk_rope_dim)
                    total += self.kv_lora_rank * self.n_heads * (
                        self.qk_nope_dim + self.v_head_dim
                    )
                    total += self.n_heads * self.v_head_dim * d
                else:
                    total += d * self.n_heads * dh
                    total += 2 * d * self.n_kv_heads * dh
                    total += self.n_heads * dh * d
            elif spec.mixer == "mamba":
                di = self.mamba_expand * d
                total += d * 2 * di  # in_proj
                total += di * self.d_conv  # conv
                total += di * (self.ssm_state * 2 + 2)  # B,C,dt proj-ish + A
                total += di * d  # out_proj
            if spec.ffn == "dense" or spec.ffn == "moe_dense":
                mult = 3 if self.activation == "swiglu" else 2
                total += mult * d * self.d_ff
            if spec.ffn in ("moe", "moe_dense"):
                fe = self.d_ff_expert or self.d_ff
                total += d * self.n_experts  # router
                total += self.n_experts * 3 * d * fe
                total += self.n_shared_experts * 3 * d * fe
            total += 2 * d  # norms
        total += d  # final norm
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k + shared only)."""
        if self.n_experts == 0:
            return self.param_count()
        d = self.d_model
        fe = self.d_ff_expert or self.d_ff
        inactive = 0
        for spec in self.layers():
            if spec.ffn in ("moe", "moe_dense"):
                inactive += (self.n_experts - self.top_k) * 3 * d * fe
        return int(self.param_count() - inactive)
