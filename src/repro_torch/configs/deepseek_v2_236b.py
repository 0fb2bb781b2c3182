"""deepseek-v2-236b [arXiv:2405.04434; hf]: 60L d_model=5120 128H MLA
(kv_lora=512, rope 64) d_ff_expert=1536 vocab=102400, MoE 2 shared + 160
routed top-6; first layer dense (d_ff 12288)."""
from repro_torch.models.config import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        d_model=5120,
        vocab_size=102400,
        prefix=(LayerSpec("attn", "dense"),),
        block=(LayerSpec("attn", "moe"),),
        n_blocks=59,
        n_heads=128,
        n_kv_heads=128,
        use_mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_rope_dim=64,
        qk_nope_dim=128,
        v_head_dim=128,
        d_ff=12288,
        d_ff_expert=1536,
        n_experts=160,
        top_k=6,
        n_shared_experts=2,
        activation="swiglu",
        opt_state_dtype="bfloat16",
    )
