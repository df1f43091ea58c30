"""grok-1-314b — 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2.

[hf:xai-org/grok-1; unverified]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("grok-1-314b")
def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=32768,             # per-expert ffn width
        vocab_size=131072,
        qkv_bias=False,
        tie_embeddings=False,
        rope_theta=10000.0,
        rms_norm_eps=1e-5,
        logit_softcap=30.0,
        moe=MoEConfig(
            num_experts=8,
            top_k=2,
            expert_d_ff=32768,
            capacity_factor=1.25,
            group_size=1024,
        ),
    )
