"""Architecture configs of the ported slice + registry."""
from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    SSMConfig,
    register,
    get_config,
    list_configs,
)

# Import every architecture module so registration side effects run.
from repro_torch.configs import (  # noqa: F401
    mamba2_1_3b,
    qwen2_0_5b,
    smollm_360m,
)

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "register",
    "get_config",
    "list_configs",
]
