"""granite-moe-3b-a800m — 32L d_model=1536 24H (GQA kv=8) per-expert
d_ff=512 vocab=49155, MoE 40 experts top-8.

[hf:ibm-granite/granite-3.0-3b-a800m-base; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("granite-moe-3b-a800m")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        d_ff=512,               # per-expert ffn width
        vocab_size=49155,
        qkv_bias=False,
        tie_embeddings=True,
        rope_theta=10000.0,
        rms_norm_eps=1e-6,
        moe=MoEConfig(
            num_experts=40,
            top_k=8,
            expert_d_ff=512,
            capacity_factor=1.25,
            group_size=512,
        ),
    )
