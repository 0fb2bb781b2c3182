"""deepseek-coder-33b [arXiv:2401.14196; hf]: llama-arch dense 62L
d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256."""
from repro_torch.models.config import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        family="dense",
        d_model=7168,
        vocab_size=32256,
        block=(LayerSpec("attn", "dense"),),
        n_blocks=62,
        n_heads=56,
        n_kv_heads=8,
        d_ff=19200,
        activation="swiglu",
    )
