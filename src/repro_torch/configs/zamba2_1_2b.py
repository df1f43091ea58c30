"""zamba2-1.2b — 38 Mamba2 layers d_model=2048, shared full-attention block
(32H kv=32, d_ff=8192) applied every 6 SSM blocks with per-site LoRA,
vocab=32000, ssm_state=64.

Hybrid Mamba2 + shared attention. [arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


@register("zamba2-1.2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=32000,
        qkv_bias=False,
        tie_embeddings=True,
        rope_theta=10000.0,
        rms_norm_eps=1e-5,
        ssm=SSMConfig(d_state=64, expand=2, head_dim=64, chunk_size=256),
        shared_attn_every=6,
        shared_attn_lora_rank=128,
        supports_long_context=True,
    )
