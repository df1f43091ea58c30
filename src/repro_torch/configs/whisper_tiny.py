"""whisper-tiny — enc-dec, 4L encoder + 4L decoder, d_model=384 6H (kv=6)
d_ff=1536 vocab=51865. Conv audio frontend is a STUB: ``input_specs()``
provides precomputed frame embeddings [B, frames, d_model].

[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-tiny")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="audio",
        num_layers=4,                 # decoder layers
        num_encoder_layers=4,
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        d_ff=1536,
        vocab_size=51865,
        qkv_bias=True,                # whisper uses biased q/v projections
        tie_embeddings=True,
        is_encoder_decoder=True,
        encoder_frames=1500,          # 30 s of audio after conv frontend
        learned_pos_embed=True,
        frontend_stub="audio",
        rms_norm_eps=1e-5,
        max_position_embeddings=65536,   # covers decode_32k positions
    )
