"""The LM substrate of the port (port of ``repro.models``): configs, layers,
GQA attention and Mamba on the port's kernels, and the model."""
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.model import Model

__all__ = ["LayerSpec", "ModelConfig", "Model"]
