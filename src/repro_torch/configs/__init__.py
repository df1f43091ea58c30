"""Architecture configs (one module per architecture of the JAX package)
+ registry, and the assigned input shapes (``shapes``) as plain data."""
from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    SSMConfig,
    register,
    get_config,
    list_configs,
)
from repro_torch.configs import shapes  # noqa: F401

# Import every architecture module so registration side effects run.
from repro_torch.configs import (  # noqa: F401
    qwen2_0_5b,
    qwen2_5_3b,
    smollm_360m,
    llama3_405b,
    granite_moe_3b_a800m,
    grok1_314b,
    zamba2_1_2b,
    whisper_tiny,
    pixtral_12b,
    mamba2_1_3b,
)

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "register",
    "get_config",
    "list_configs",
    "shapes",
]
