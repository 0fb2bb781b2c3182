"""qwen3-8b [hf:Qwen/Qwen3-8B; hf]: dense 36L d_model=4096 32H (GQA kv=8,
head_dim 128) d_ff=12288 vocab=151936, qk-norm."""
from repro_torch.models.config import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b",
        family="dense",
        d_model=4096,
        vocab_size=151936,
        block=(LayerSpec("attn", "dense"),),
        n_blocks=36,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=12288,
        qk_norm=True,
        activation="swiglu",
        rope_theta=1e6,
    )
