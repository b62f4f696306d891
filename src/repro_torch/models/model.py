"""The paper's Table-I network (the ``mlp`` family), batched over clients.

Port of the ``mlp`` family of ``repro.models.model``. The personalized-FL
split of eq. (2) is structural: trunk ``fc0..fc3`` (shared) -> ``final``,
the last shared layer ω̃ that FedGradNorm differentiates -> a per-client
head padded to the largest class count. Every apply function accepts
parameters with leading batch axes matching the input's (the simulator's
(C, N) clients each hold their own copy) or without them (one shared
copy broadcast over the batch), so the reference's (C, N) ``vmap`` is a
batched matmul here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models.params import ParamSpec

# paper Table I: shared network FC dims (input 256 -> ... -> 256 out)
PAPER_MLP_DIMS = (256, 512, 1024, 2048, 512, 256)


def _dense(h: torch.Tensor, p) -> torch.Tensor:
    """h @ w + b with w (..., din, dout) and b (..., dout)."""
    return torch.matmul(h, p["w"]) + p["b"].unsqueeze(-2)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    dims: Tuple[int, ...] = field(default=PAPER_MLP_DIMS)

    def __post_init__(self):
        if self.cfg.family != "mlp":
            raise ValueError(f"the port builds only the 'mlp' family, got "
                             f"{self.cfg.family!r}")

    # ---------------- specs ----------------
    def trunk_specs(self):
        d = self.dims
        return {f"fc{i}": {"w": ParamSpec((d[i], d[i + 1])),
                           "b": ParamSpec((d[i + 1],), "zeros")}
                for i in range(len(d) - 2)}   # all but the last FC

    def final_specs(self):
        d = self.dims
        return {"w": ParamSpec((d[-2], d[-1])),
                "b": ParamSpec((d[-1],), "zeros")}

    def head_specs(self, n_out: int):
        return {"w": ParamSpec((self.dims[-1], n_out)),
                "b": ParamSpec((n_out,), "zeros")}

    # ---------------- apply ----------------
    def trunk_apply(self, params, inputs: torch.Tensor) -> torch.Tensor:
        h = inputs
        for i in range(len(self.dims) - 2):
            h = torch.relu(_dense(h, params[f"fc{i}"]))
        return h

    def final_apply(self, params, hidden: torch.Tensor) -> torch.Tensor:
        return torch.relu(_dense(hidden, params))

    def head_apply(self, params, features: torch.Tensor) -> torch.Tensor:
        return _dense(features, params)

    def features(self, omega, inputs: torch.Tensor) -> torch.Tensor:
        """final(trunk(x)): the shared network's output."""
        return self.final_apply(omega["final"],
                                self.trunk_apply(omega["trunk"], inputs))


def build_model(cfg: ModelConfig, dims: Tuple[int, ...] = PAPER_MLP_DIMS
                ) -> Model:
    return Model(cfg, tuple(dims))
