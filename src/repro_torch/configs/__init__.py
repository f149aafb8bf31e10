"""Architecture configs of the port (its own copies of the reference's)."""

from repro_torch.configs.registry import (
    ARCH_IDS,
    NUM_MICRO,
    REMAT_GROUP,
    get_config,
    reduced_config,
    serving_config,
    training_config,
)

__all__ = ["ARCH_IDS", "NUM_MICRO", "REMAT_GROUP", "get_config", "reduced_config",
           "serving_config", "training_config"]
