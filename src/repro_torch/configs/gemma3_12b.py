"""gemma3-12b [hf:google/gemma-3-1b-pt family; unverified]: 48L d_model=3840
16H (GQA kv=8, head_dim 256) d_ff=15360 vocab=262144; 5:1 local:global
(sliding window 1024), qk-norm, scaled embeddings."""
from repro_torch.models.config import LayerSpec, ModelConfig

_LOCAL = LayerSpec("attn", "dense", window=1024)
_GLOBAL = LayerSpec("attn", "dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        family="dense",
        d_model=3840,
        vocab_size=262144,
        block=(_LOCAL,) * 5 + (_GLOBAL,),
        n_blocks=8,
        n_heads=16,
        n_kv_heads=8,
        d_head=256,
        d_ff=15360,
        qk_norm=True,
        embed_scale=True,
        tie_embeddings=True,
        activation="gelu",
        rope_theta=1e6,
    )
