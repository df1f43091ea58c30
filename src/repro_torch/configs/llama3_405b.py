"""llama3-405b — 126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256.

GQA, 128k vocab. [arXiv:2407.21783; unverified]
"""
from repro_torch.configs.base import ModelConfig, register


@register("llama3-405b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b",
        family="dense",
        num_layers=126,
        d_model=16384,
        num_heads=128,
        num_kv_heads=8,
        d_ff=53248,
        vocab_size=128256,
        qkv_bias=False,
        tie_embeddings=False,
        rope_theta=500_000.0,
        rms_norm_eps=1e-5,
        remat_policy="full",
    )
