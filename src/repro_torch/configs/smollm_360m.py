"""smollm-360m — 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.

Llama-architecture small model. [hf:HuggingFaceTB/SmolLM-360M; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register("smollm-360m")
def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        family="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        d_ff=2560,
        vocab_size=49152,
        qkv_bias=False,
        tie_embeddings=True,
        rope_theta=10000.0,
        rms_norm_eps=1e-5,
    )
