"""Optimizers, schedules and clipping (port of ``repro.optim``)."""
from repro_torch.optim.adam import AdamState, adam_init, adam_update
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.schedules import (
    constant, cosine_decay, linear_warmup_cosine,
)
from repro_torch.optim.sgd import sgd_update

__all__ = [
    "AdamState", "adam_init", "adam_update", "sgd_update",
    "constant", "cosine_decay", "linear_warmup_cosine", "clip_by_global_norm",
]
