"""Model facade over the families the port builds: ``mlp`` and ``dense``
(with ``moe``, its alias in the reference).

Port of ``repro.models.model``. The personalized-FL split of eq. (2) is
structural: trunk (shared) -> ``final``, the last shared layer ω̃ that
FedGradNorm differentiates -> a per-client head.

* ``mlp``: the paper's Table-I network, batched over clients: trunk
  ``fc0..fc3`` -> ``final`` -> a head padded to the largest class count.
  Every apply function accepts parameters with leading batch axes
  matching the input's (the simulator's (C, N) clients each hold their
  own copy) or without them (one shared copy broadcast over the batch),
  so the reference's (C, N) ``vmap`` is a batched matmul here.
* ``dense`` (and ``moe``): the decoder LM of ``models/transformer.py``
  (embedding and stacked layers) -> final RMSNorm -> a vocab head with
  float32 logits, for training, prefill and decode. ``cfg.moe`` puts the
  MoE block of ``models/moe.py`` in every layer (Mixtral, Phi-3.5-MoE);
  ``cfg.modality`` "audio" (EnCodec token ids) or "vision" (projected
  patch embeddings, (B, S, d_model) floats) selects the stub frontend's
  inputs (``launch.steps.input_specs``): the trunk takes token ids or
  float embeddings alike. SSM, xLSTM and hybrid families wait for
  ROADMAP Queue 1, item 14.4.

``trunk_apply`` returns (hidden, aux_loss, new_cache) for both families,
as the reference's does; ``lm_loss`` and ``cls_loss`` are the
reference's cross-entropies.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
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
        if self.cfg.family not in ("mlp", "dense", "moe"):
            raise NotImplementedError(
                f"the port builds the 'mlp', 'dense' and 'moe' families, got "
                f"{self.cfg.family!r} (ROADMAP Queue 1, item 14)")

    @property
    def is_lm(self) -> bool:
        return self.cfg.family in ("dense", "moe")

    # ---------------- specs ----------------
    def trunk_specs(self):
        if self.is_lm:
            return T.dense_trunk_specs(self.cfg)
        d = self.dims
        return {f"fc{i}": {"w": ParamSpec((d[i], d[i + 1]),
                                          axes=("embed", "mlp")),
                           "b": ParamSpec((d[i + 1],), "zeros",
                                          axes=("mlp",))}
                for i in range(len(d) - 2)}   # all but the last FC

    def final_specs(self):
        if self.is_lm:
            return T.final_specs(self.cfg)
        d = self.dims
        return {"w": ParamSpec((d[-2], d[-1]), axes=("embed", "mlp")),
                "b": ParamSpec((d[-1],), "zeros", axes=("mlp",))}

    def head_specs(self, n_out=None):
        if self.is_lm:
            return {"w": ParamSpec((self.cfg.d_model,
                                    n_out or self.cfg.vocab_size),
                                   axes=("embed", "vocab"))}
        return {"w": ParamSpec((self.dims[-1], n_out),
                               axes=("embed", "vocab")),
                "b": ParamSpec((n_out,), "zeros", axes=("vocab",))}

    def backbone_specs(self):
        return {"trunk": self.trunk_specs(), "final": self.final_specs()}

    # ---------------- apply ----------------
    def trunk_apply(self, params, inputs: torch.Tensor, *, positions=None,
                    mode: str = "train", cache=None, cache_len=None,
                    param_hook=None):
        """(hidden, aux, new_cache) as in the reference (``mlp``: the
        trunk's features, a zero aux and no cache). ``param_hook(params,
        klass, *tags)`` (the distributed per-leaf oracle,
        ``core.hota.make_param_hook``) sees the ``mlp`` trunk's parameters
        as one "layers" call, the dense trunk's embedding as "embed" and
        each layer's parameters as "layers" with the layer index as the
        last tag, right before they are used."""
        if not self.is_lm:
            if param_hook is not None:
                params = param_hook(params, "layers")
            h = inputs
            for i in range(len(self.dims) - 2):
                h = torch.relu(_dense(h, params[f"fc{i}"]))
            return h, torch.zeros((), dtype=torch.float32,
                                  device=h.device), None
        if positions is None:
            positions = torch.arange(inputs.shape[1], device=inputs.device)
        return T.dense_trunk_apply(params, inputs, self.cfg,
                                   positions=positions, mode=mode,
                                   cache=cache, cache_len=cache_len,
                                   param_hook=param_hook)

    def final_apply(self, params, hidden: torch.Tensor) -> torch.Tensor:
        if self.is_lm:
            return L.rms_norm(hidden, params["norm"], self.cfg.norm_eps)
        return torch.relu(_dense(hidden, params))

    def head_apply(self, params, features: torch.Tensor) -> torch.Tensor:
        if self.is_lm:   # logits in float32
            return (features @ params["w"].to(features.dtype)).float()
        return _dense(features, params)

    def features(self, omega, inputs: torch.Tensor) -> torch.Tensor:
        """final(trunk(x)): the shared network's output (``mlp``)."""
        return self.final_apply(omega["final"],
                                self.trunk_apply(omega["trunk"], inputs)[0])

    # ---------------- LM caches and logits ----------------
    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                   device="cuda"):
        if not self.is_lm:
            raise ValueError("the mlp family has no cache")
        return T.init_dense_cache(self.cfg, batch, cache_len, dtype, device)

    def forward_logits(self, backbone_params, head_params, inputs, *,
                       positions=None, mode="train", cache=None,
                       cache_len=None):
        """(logits, aux, new_cache)."""
        h, aux, new_cache = self.trunk_apply(
            backbone_params["trunk"], inputs, positions=positions, mode=mode,
            cache=cache, cache_len=cache_len)
        feats = self.final_apply(backbone_params["final"], h)
        return self.head_apply(head_params, feats), aux, new_cache


def build_model(cfg: ModelConfig, dims: Tuple[int, ...] = PAPER_MLP_DIMS
                ) -> Model:
    return Model(cfg, tuple(dims))


def log_likelihoods(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """log softmax(logits)[label] per position, in float32."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(logp, -1,
                        labels.to(torch.int64).unsqueeze(-1)).squeeze(-1)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over the vocab; logits (B, S, V), labels (B, S)."""
    return -torch.mean(log_likelihoods(logits, labels))


def cls_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return lm_loss(logits, labels)
