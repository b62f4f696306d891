"""The model zoo's facade (port of ``repro.models``)."""
from repro_torch.models.model import (
    PAPER_MLP_DIMS, Model, build_model, cls_loss, lm_loss,
)
from repro_torch.models.params import (
    ParamSpec, abstract_params, init_params, logical_axes, param_count,
    spec_shapes,
)

__all__ = [
    "Model", "build_model", "lm_loss", "cls_loss", "PAPER_MLP_DIMS",
    "ParamSpec", "init_params", "logical_axes", "abstract_params",
    "param_count", "spec_shapes",
]
