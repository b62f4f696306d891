"""Architecture configs: every model the reference builds (the dense
family with its MoE layer and audio and vision stub frontends, the
Zamba2 hybrid, xLSTM) and the paper's MLP.

Copied from the JAX package's ``repro.configs`` so the port depends on
nothing there: ids (in the reference's order), aliases, full-size
``CONFIG`` and reduced ``SMOKE_CONFIG`` are the reference's.
``get_config(name)`` returns the full-size ``ModelConfig``,
``get_smoke_config(name)`` the reduced one, ``all_configs()`` every
full-size config by id.

``PORT_ARCH_IDS`` and ``PORT_ALIASES`` name the architectures the port
builds and the reference does not (Granite-4.0-H-Small, the
``hybrid_moe`` family): ``get_config`` and ``get_smoke_config`` find
them, and ``ARCH_IDS``, ``ALIASES`` and ``all_configs()`` stay the
reference's.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.common.config import ModelConfig

ARCH_IDS: List[str] = [
    "starcoder2_3b",
    "stablelm_3b",
    "musicgen_medium",
    "phi3_vision_4_2b",
    "gemma3_12b",
    "zamba2_1_2b",
    "phi3_5_moe_42b",
    "xlstm_1_3b",
    "mixtral_8x22b",
    "qwen2_5_14b",
    "paper_mlp",
]

# CLI-friendly aliases, as in the reference
ALIASES: Dict[str, str] = {
    "starcoder2-3b": "starcoder2_3b",
    "stablelm-3b": "stablelm_3b",
    "musicgen-medium": "musicgen_medium",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "gemma3-12b": "gemma3_12b",
    "zamba2-1.2b": "zamba2_1_2b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "xlstm-1.3b": "xlstm_1_3b",
    "mixtral-8x22b": "mixtral_8x22b",
    "qwen2.5-14b": "qwen2_5_14b",
    "paper-mlp": "paper_mlp",
}


PORT_ARCH_IDS: List[str] = ["granite_4_0_h_small"]

PORT_ALIASES: Dict[str, str] = {
    "granite-4.0-h-small": "granite_4_0_h_small",
}


def _module(name: str):
    name = ALIASES.get(name, PORT_ALIASES.get(name, name))
    if name not in ARCH_IDS + PORT_ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}; known: "
                         f"{ARCH_IDS + PORT_ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE_CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_IDS}
