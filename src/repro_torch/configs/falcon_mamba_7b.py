"""falcon-mamba-7b [arXiv:2410.05355; unverified]: attention-free mamba1
arch, 64L d_model=4096 ssm_state=16 vocab=65024."""
from repro_torch.models.config import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        d_model=4096,
        vocab_size=65024,
        block=(LayerSpec("mamba", "none"),),
        n_blocks=64,
        ssm_state=16,
        d_conv=4,
        mamba_expand=2,
    )
