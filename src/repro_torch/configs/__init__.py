"""Architecture registry of the port: ``get_config(arch)``, the reduced
smoke-test variants and ``get_model_config`` (the launchers' name parser).

The port serves and trains qwen3-8b (dense GQA with qk-norm),
falcon-mamba-7b (attention-free Mamba-1), the dense minitron-8b (squared
ReLU) and deepseek-coder-33b, the MoE families jamba-v0.1-52b (Mamba and
attention 7:1, a 16-expert top-2 MoE every other layer) and arctic-480b (a
dense FFN beside a 128-expert top-2 MoE in every layer), gemma3-12b (five
sliding-window layers to one global, head dim 256, a ring cache), the
encoder-only hubert-xlarge (frame inputs, bidirectional, head dim 80; no
decode path) and llama-3.2-vision-90b (a gated cross-attention layer every
fifth) and deepseek-v2-236b (MLA with its absorbed decode, a dense prefix
layer before 59 blocks of a 160-expert top-6 MoE with 2 shared experts): all
ten of the reference's configs. ``launch/train.py`` adds the reference's
``repro-100m``. An architecture the port is to run later goes into ``LATER``,
and asking for it raises ``NotImplementedError`` naming the ROADMAP item
that brings it.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import LATER_ITEM, LayerSpec, ModelConfig

ARCHS = ["qwen3_8b", "falcon_mamba_7b", "minitron_8b", "deepseek_coder_33b", "jamba_v01_52b",
         "arctic_480b", "gemma3_12b", "hubert_xlarge", "llama32_vision_90b", "deepseek_v2_236b"]

# canonical ids, as the reference names them
ALIASES = {
    "qwen3-8b": "qwen3_8b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "minitron-8b": "minitron_8b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "arctic-480b": "arctic_480b",
    "gemma3-12b": "gemma3_12b",
    "hubert-xlarge": "hubert_xlarge",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "deepseek-v2-236b": "deepseek_v2_236b",
}

# the reference's architectures (by canonical id) that the port does not run
# yet, and what each waits for: none since deepseek-v2-236b
LATER: dict[str, str] = {}


def _module(arch: str):
    if arch in LATER:
        raise NotImplementedError(
            f"{arch}: the port does not run it yet ({LATER[arch]}); {LATER_ITEM}")
    name = ALIASES.get(arch, arch).replace("-", "_")
    if name not in ARCHS:
        raise ValueError(f"unknown architecture {arch!r}; the port has {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_reduced_config(arch: str) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (the reference's)."""
    return shrink(_module(arch).config())


def get_model_config(name: str) -> ModelConfig:
    """``"reduced:<arch>"`` or ``"<arch>"``, as the reference's launchers
    parse ``--arch``."""
    if name.startswith("reduced:"):
        return get_reduced_config(name.split(":", 1)[1])
    return get_config(name)


def shrink(cfg: ModelConfig) -> ModelConfig:
    """Generic reduction: small width/depth/vocab/experts, same structure."""

    def small_spec(s: LayerSpec) -> LayerSpec:
        return dataclasses.replace(s, window=min(s.window, 16) if s.window else None)

    changes = dict(
        d_model=128,
        d_ff=256 if cfg.d_ff else 0,
        d_ff_expert=128 if cfg.d_ff_expert else 0,
        vocab_size=512,
        n_blocks=2,
        prefix=tuple(small_spec(s) for s in cfg.prefix),
        block=tuple(small_spec(s) for s in cfg.block),
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_head=32 if cfg.d_head else None,
        n_experts=8 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        n_img_tokens=16 if cfg.n_img_tokens else 0,
        remat=False,
    )
    if cfg.use_mla:
        changes.update(
            kv_lora_rank=32, q_lora_rank=48 if cfg.q_lora_rank else None,
            qk_rope_dim=16, qk_nope_dim=32, v_head_dim=32,
        )
    return dataclasses.replace(cfg, **changes)
