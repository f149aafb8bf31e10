"""Architecture configs of the port (its own copies of the reference's)."""

from repro_torch.configs.registry import (
    ARCH_IDS,
    CRITEO39_VOCABS,
    EMBED_DIM_RETRIEVAL,
    GNN_ARCH_IDS,
    GNN_CELLS,
    NUM_MICRO,
    RECSYS_ARCH_IDS,
    RECSYS_CELLS,
    REMAT_GROUP,
    get_config,
    gnn_cell_config,
    reduced_config,
    reduced_gnn_config,
    reduced_recsys_config,
    serving_config,
    training_config,
)

__all__ = ["ARCH_IDS", "CRITEO39_VOCABS", "EMBED_DIM_RETRIEVAL", "GNN_ARCH_IDS", "GNN_CELLS",
           "NUM_MICRO", "RECSYS_ARCH_IDS", "RECSYS_CELLS", "REMAT_GROUP", "get_config",
           "gnn_cell_config", "reduced_config", "reduced_gnn_config", "reduced_recsys_config",
           "serving_config", "training_config"]
