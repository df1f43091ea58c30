"""qwen2.5-3b — 36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.

GQA with QKV bias. [hf:Qwen/Qwen2.5-3B; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2.5-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b",
        family="dense",
        num_layers=36,
        d_model=2048,
        num_heads=16,
        num_kv_heads=2,
        d_ff=11008,
        vocab_size=151936,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        rms_norm_eps=1e-6,
    )
