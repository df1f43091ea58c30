"""Model configuration dataclasses + architecture registry (plain data,
a copy of the JAX package's ``configs/base.py``)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    capacity_factor: float = 1.25
    # tokens are dispatched in groups to bound the dispatch-tensor size
    group_size: int = 4096
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1
    a_init_range: tuple[float, float] = (1.0, 16.0)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None    # default d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # hybrid (zamba2-style): a shared-parameter attention block is applied
    # after every `shared_attn_every` ssm blocks, with per-site LoRA deltas.
    shared_attn_every: int = 0
    shared_attn_lora_rank: int = 0
    # encoder-decoder (whisper-style)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_frames: int = 0         # stub audio frontend sequence length
    learned_pos_embed: bool = False  # decoder learned positions (whisper)
    max_position_embeddings: int = 1 << 20
    # modality frontend stub: model consumes precomputed embeddings appended
    # to the token embeddings (pixtral patch embeds)
    frontend_stub: str | None = None  # None | "audio" | "vision"
    # attention implementation: "xla" (chunked online-softmax) |
    # "xla_blockskip" (causal lower-triangular block schedule, ~2× fewer
    # attention FLOPs) | "pallas"
    attention_impl: str = "xla"
    # pad attention heads up to a multiple of this so the head dim shards
    # over the tensor axis (zero-padded weights receive exactly zero
    # gradient — model is mathematically unchanged; see EXPERIMENTS §Perf)
    pad_heads_to: int = 0
    attention_chunk: int = 1024
    decode_chunk: int = 4096
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # remat: "none" | "full" | "dots" | "subblock" | "attn_only"
    remat_policy: str = "full"
    # LM loss: "plain" ([B,S,V] f32 logits) | "chunked_vocab" (online-
    # softmax over vocab blocks; avoids the full logits materialization)
    loss_impl: str = "plain"
    loss_vocab_chunk: int = 8192
    # KV cache storage: "bf16" | "int8" (per-position-channel scales;
    # halves the decode cache stream — the dominant decode memory term)
    kv_cache_dtype: str = "bf16"
    # sharding rule overrides for this arch (logical axis -> candidates)
    sharding_overrides: Mapping[str, Sequence[tuple[str, ...]]] | None = None
    # long-context applicability (full-attention archs skip long_500k)
    supports_long_context: bool = False
    # logit softcap (grok uses 30.0)
    logit_softcap: float = 0.0

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # Analytical parameter / FLOP counts (used for roofline MODEL_FLOPS)
    # ------------------------------------------------------------------
    def param_count(self) -> int:
        from repro_torch.models import registry
        return registry.param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models import registry
        return registry.param_count(self, active_only=True)


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str, **overrides: Any) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    if overrides:
        cfg = cfg.with_overrides(**overrides)
    return cfg


def list_configs() -> list[str]:
    return sorted(_REGISTRY)
