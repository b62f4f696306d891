"""Configs and tree helpers (port of ``repro.common``)."""
from repro_torch.common.config import (
    INPUT_SHAPES, FLConfig, HybridConfig, InputShape, MeshConfig,
    ModelConfig, MoEConfig, SSMConfig, ServeConfig, TrainConfig,
    XLSTMConfig,
)
from repro_torch.common.tree import (
    tree_cast, tree_global_norm, tree_size, tree_zeros_like,
)

__all__ = [
    "FLConfig", "HybridConfig", "INPUT_SHAPES", "InputShape", "MeshConfig",
    "ModelConfig", "MoEConfig", "SSMConfig", "ServeConfig", "TrainConfig",
    "XLSTMConfig", "tree_cast", "tree_global_norm", "tree_size",
    "tree_zeros_like",
]
