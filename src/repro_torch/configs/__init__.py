"""Architecture configs of the port (its own copies of the reference's)."""

from repro_torch.configs.registry import ARCH_IDS, get_config, serving_config

__all__ = ["ARCH_IDS", "get_config", "serving_config"]
