"""hubert-xlarge [arXiv:2106.07447; unverified]: encoder-only 48L
d_model=1280 16H d_ff=5120 vocab=504 (masked-unit prediction targets).
The conv waveform frontend is a STUB: the model takes precomputed frame
embeddings at d_model width (``inputs["frames"]``)."""
from repro_torch.models.config import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge",
        family="audio",
        d_model=1280,
        vocab_size=504,
        block=(LayerSpec("attn", "dense"),),
        n_blocks=48,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        causal=False,  # encoder-only: no decode shapes
        activation="gelu",
        frontend="frames",
    )
