"""minitron-8b [arXiv:2407.14679; hf]: pruned nemotron, dense 32L
d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000, squared-ReLU FFN."""
from repro_torch.models.config import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        family="dense",
        d_model=4096,
        vocab_size=256000,
        block=(LayerSpec("attn", "dense"),),
        n_blocks=32,
        n_heads=32,
        n_kv_heads=8,
        d_ff=16384,
        activation="sq_relu",
    )
