"""Architecture configs of the port (its own copies of the reference's)."""

from repro_torch.configs.registry import (
    ARCH_IDS,
    CRITEO39_VOCABS,
    EMBED_DIM_RETRIEVAL,
    NUM_MICRO,
    RECSYS_ARCH_IDS,
    RECSYS_CELLS,
    REMAT_GROUP,
    get_config,
    reduced_config,
    reduced_recsys_config,
    serving_config,
    training_config,
)

__all__ = ["ARCH_IDS", "CRITEO39_VOCABS", "EMBED_DIM_RETRIEVAL", "NUM_MICRO", "RECSYS_ARCH_IDS",
           "RECSYS_CELLS", "REMAT_GROUP", "get_config", "reduced_config", "reduced_recsys_config",
           "serving_config", "training_config"]
