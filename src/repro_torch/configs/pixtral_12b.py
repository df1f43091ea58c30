"""pixtral-12b — 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.

Pixtral-ViT vision frontend is a STUB (``input_specs()`` provides
precomputed patch embeddings); this config is the mistral-nemo-style
multimodal decoder backbone. [hf:mistralai/Pixtral-12B-2409; unverified]
"""
from repro_torch.configs.base import ModelConfig, register


@register("pixtral-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        family="vlm",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        qkv_bias=False,
        tie_embeddings=False,
        rope_theta=1_000_000_000.0,
        rms_norm_eps=1e-5,
        frontend_stub="vision",
    )
