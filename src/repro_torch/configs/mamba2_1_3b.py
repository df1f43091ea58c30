"""mamba2-1.3b — 48L d_model=2048, attention-free, vocab=50280,
ssm_state=128. SSD (state-space duality) blocks.

[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


@register("mamba2-1.3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=0,              # attention-free
        num_kv_heads=0,
        d_ff=0,                   # no separate MLP; SSD block carries the FFN
        vocab_size=50280,
        tie_embeddings=True,
        rms_norm_eps=1e-5,
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, chunk_size=256),
        supports_long_context=True,
    )
