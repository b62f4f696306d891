"""Model facade: one interface over every backbone family.

Port of ``repro.models.model``. The personalized-FL split of eq. (2) is
structural: trunk (shared) -> ``final``, the last shared layer ω̃ that
FedGradNorm differentiates -> a per-client head.

* ``mlp``: the paper's Table-I network, batched over clients: trunk
  ``fc0..fc3`` -> ``final`` -> a head padded to the largest class count.
  Every apply function accepts parameters with leading batch axes
  matching the input's (the simulator's (C, N) clients each hold their
  own copy) or without them (one shared copy broadcast over the batch),
  so the reference's (C, N) ``vmap`` is a batched matmul here.
* the language models: a trunk -> final RMSNorm -> a vocab head with
  float32 logits, for training, prefill and decode:

  - ``dense`` (and ``moe``, its alias in the reference): the decoder of
    ``models/transformer.py``; ``cfg.moe`` puts the MoE block of
    ``models/moe.py`` in every layer (Mixtral, Phi-3.5-MoE);
    ``cfg.modality`` "audio" (EnCodec token ids) or "vision" (projected
    patch embeddings, (B, S, d_model) floats) selects the stub
    frontend's inputs (``launch.steps.input_specs``);
  - ``hybrid``: Zamba2's Mamba2 backbone with one shared attention
    block (``models/hybrid.py``);
  - ``xlstm``: super-blocks of mLSTM and sLSTM (``models/xlstm.py``);
  - ``ssm``: a pure stack of Mamba2 layers (``models/mamba2.py``),
    hooked as ("layers", i);
  - ``hybrid_moe``: the port's own Granite-4.0-H family, per-layer
    Mamba2 or attention mixers each followed by an MoE block with a
    shared expert (``models/hybrid_moe.py``); its logits are divided by
    ``cfg.logits_scaling``.

  Every trunk takes token ids or float embeddings alike.

``trunk_apply`` returns (hidden, aux_loss, new_cache) for every family,
as the reference's does; ``lm_loss`` and ``cls_loss`` are the
reference's cross-entropies.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models import hybrid as HY
from repro_torch.models import hybrid_moe as HM
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as XL
from repro_torch.models.params import ParamSpec

FAMILIES = ("mlp", "dense", "moe", "hybrid", "xlstm", "ssm", "hybrid_moe")

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
        if self.cfg.family not in FAMILIES:
            raise ValueError(f"unknown model family {self.cfg.family!r}; "
                             f"known: {FAMILIES}")

    @property
    def is_lm(self) -> bool:
        return self.cfg.family != "mlp"

    # ---------------- specs ----------------
    def trunk_specs(self):
        cfg = self.cfg
        if cfg.family in ("dense", "moe"):
            return T.dense_trunk_specs(cfg)
        if cfg.family == "hybrid":
            return HY.hybrid_trunk_specs(cfg)
        if cfg.family == "hybrid_moe":
            return HM.hybrid_moe_trunk_specs(cfg)
        if cfg.family == "xlstm":
            return XL.xlstm_trunk_specs(cfg)
        if cfg.family == "ssm":
            return {"embed": ParamSpec((cfg.vocab_size, cfg.d_model),
                                       "embed", axes=("vocab", "embed")),
                    "layers": T._stack(M2.mamba2_specs(cfg), cfg.n_layers)}
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
        as one "layers" call; an LM's embedding as "embed" and its blocks
        right before they are used: the dense and ``ssm`` trunks' layers
        as "layers" with the layer index as the last tag, the hybrid's
        and xLSTM's as their modules say."""
        if not self.is_lm:
            if param_hook is not None:
                params = param_hook(params, "layers")
            h = inputs
            for i in range(len(self.dims) - 2):
                h = torch.relu(_dense(h, params[f"fc{i}"]))
            return h, torch.zeros((), dtype=torch.float32,
                                  device=h.device), None
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(inputs.shape[1], device=inputs.device)
        kw = dict(positions=positions, mode=mode, cache=cache,
                  cache_len=cache_len, param_hook=param_hook)
        if cfg.family == "hybrid":
            return HY.hybrid_trunk_apply(params, inputs, cfg, **kw)
        if cfg.family == "hybrid_moe":
            return HM.hybrid_moe_trunk_apply(params, inputs, cfg, **kw)
        if cfg.family == "xlstm":
            return XL.xlstm_trunk_apply(params, inputs, cfg, **kw)
        if cfg.family == "ssm":
            x, new_cache = M2.mamba_stack_apply(
                params["layers"], T.embed_inputs(params, inputs, cfg,
                                                 param_hook),
                cfg, mode=mode, cache=cache, param_hook=param_hook)
            return x, torch.zeros((), dtype=torch.float32,
                                  device=x.device), new_cache
        return T.dense_trunk_apply(params, inputs, cfg, **kw)

    def final_apply(self, params, hidden: torch.Tensor) -> torch.Tensor:
        if self.is_lm:
            return L.rms_norm(hidden, params["norm"], self.cfg.norm_eps)
        return torch.relu(_dense(hidden, params))

    def head_apply(self, params, features: torch.Tensor) -> torch.Tensor:
        if self.is_lm:   # logits in float32
            logits = (features @ params["w"].to(features.dtype)).float()
            if self.cfg.family == "hybrid_moe":
                return logits / self.cfg.logits_scaling
            return logits
        return _dense(features, params)

    def features(self, omega, inputs: torch.Tensor) -> torch.Tensor:
        """final(trunk(x)): the shared network's output (``mlp``)."""
        return self.final_apply(omega["final"],
                                self.trunk_apply(omega["trunk"], inputs)[0])

    # ---------------- LM caches and logits ----------------
    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                   device="cuda"):
        """An empty cache for decode from scratch, every layer's state in
        its own storage, on the card unless the caller asks for the
        CPU."""
        cfg = self.cfg
        if not self.is_lm:
            raise ValueError("the mlp family has no cache")
        if cfg.family == "hybrid":
            return HY.init_hybrid_cache(cfg, batch, cache_len, dtype, device)
        if cfg.family == "hybrid_moe":
            return HM.init_hybrid_moe_cache(cfg, batch, cache_len, dtype,
                                            device)
        if cfg.family == "xlstm":
            return XL.init_xlstm_cache(cfg, batch, dtype, device)
        if cfg.family == "ssm":
            return M2.init_mamba_cache(cfg, batch, dtype, device,
                                       (cfg.n_layers,))
        return T.init_dense_cache(cfg, batch, cache_len, dtype, device)

    def cache_axes(self):
        """The cache's logical axes, leaf for leaf (the reference's
        sharding names)."""
        cfg = self.cfg
        if not self.is_lm:
            raise ValueError("the mlp family has no cache")
        if cfg.family == "hybrid":
            return HY.hybrid_cache_axes(cfg)
        if cfg.family == "hybrid_moe":
            return HM.hybrid_moe_cache_axes()
        if cfg.family == "xlstm":
            return XL.xlstm_cache_axes()
        if cfg.family == "ssm":
            return {k: ("layer",) + v
                    for k, v in M2.mamba_cache_axes().items()}
        return T.dense_cache_axes(cfg)

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
