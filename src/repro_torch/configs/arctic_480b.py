"""arctic-480b [hf:Snowflake/snowflake-arctic-base; hf]: 35L d_model=7168
56H (GQA kv=8) vocab=32000; dense residual MLP (d_ff 4864) in parallel with
128-expert top-2 MoE (expert ff 4864)."""
from repro_torch.models.config import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        d_model=7168,
        vocab_size=32000,
        block=(LayerSpec("attn", "moe_dense"),),
        n_blocks=35,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        d_ff_expert=4864,
        n_experts=128,
        top_k=2,
        activation="swiglu",
        opt_state_dtype="bfloat16",
    )
