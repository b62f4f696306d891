"""Configs and tree helpers (port of ``repro.common``; ``MeshConfig`` and
``ServeConfig`` belong to the XLA tooling, ROADMAP Queue 1, item 16)."""
from repro_torch.common.config import (
    INPUT_SHAPES, FLConfig, HybridConfig, InputShape, ModelConfig, MoEConfig,
    SSMConfig, TrainConfig, XLSTMConfig,
)
from repro_torch.common.tree import (
    tree_cast, tree_global_norm, tree_size, tree_zeros_like,
)

__all__ = [
    "FLConfig", "HybridConfig", "INPUT_SHAPES", "InputShape",
    "ModelConfig", "MoEConfig", "SSMConfig", "TrainConfig",
    "XLSTMConfig", "tree_cast", "tree_global_norm", "tree_size",
    "tree_zeros_like",
]
