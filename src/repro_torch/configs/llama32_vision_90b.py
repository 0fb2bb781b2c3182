"""llama-3.2-vision-90b [hf:meta-llama/Llama-3.2-11B-Vision family;
unverified]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256 with
gated cross-attention image layers every 5th layer. The vision tower is a
STUB: the model takes precomputed patch embeddings
(``inputs["image_embeds"]``, [B, 1024, d_model])."""
from repro_torch.models.config import LayerSpec, ModelConfig

_SELF = LayerSpec("attn", "dense")
_CROSS = LayerSpec("cross_attn", "dense")


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        d_model=8192,
        vocab_size=128256,
        block=(_SELF,) * 4 + (_CROSS,),
        n_blocks=20,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        activation="swiglu",
        n_img_tokens=1024,
        cross_attn_gated=True,
        rope_theta=5e5,
        opt_state_dtype="bfloat16",
    )
