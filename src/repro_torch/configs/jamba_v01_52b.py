"""jamba-v0.1-52b [arXiv:2403.19887; hf]: hybrid Mamba+attention 1:7
interleave, 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
16-expert top-2 MoE every other layer."""
from repro_torch.models.config import LayerSpec, ModelConfig

_PERIOD = (
    LayerSpec("mamba", "dense"),
    LayerSpec("mamba", "moe"),
    LayerSpec("mamba", "dense"),
    LayerSpec("mamba", "moe"),
    LayerSpec("attn", "dense"),
    LayerSpec("mamba", "moe"),
    LayerSpec("mamba", "dense"),
    LayerSpec("mamba", "moe"),
)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        d_model=4096,
        vocab_size=65536,
        block=_PERIOD,
        n_blocks=4,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        d_ff_expert=14336,
        n_experts=16,
        top_k=2,
        ssm_state=16,
        d_conv=4,
        mamba_expand=2,
        activation="swiglu",
    )
