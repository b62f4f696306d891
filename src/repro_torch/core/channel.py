"""Runtime channel and weighting knobs as device tensors.

Port of ``repro.core.channel.ChannelParams``: the knobs a scenario sweep
varies (σ_l², H_th, AWGN std, the ``ota_on`` and ``fgn_on`` gates) are
tensors, never Python values, and every branch on them goes through
``torch.where``, so one code path serves every scenario and nothing waits
for the host. A scenario bank stacks S of them along a leading (S,) axis
(``stack_channel_params``) and hands scenario s its row
(``scenario_channel``); a cluster of the distributed step reads its own
σ² (``cluster_channel``).

* ``sigma2``      — (C,) per-cluster channel variance σ_l² (Sec. III-A)
* ``h_threshold`` — () H_th of eq. (7)
* ``noise_std``   — () AWGN std of eq. (8)
* ``ota_on``      — () 1.0 = fading MAC, 0.0 = error-free (all-pass, no noise)
* ``fgn_on``      — () 1.0 = FedGradNorm weights (Alg. 2), 0.0 = equal
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.common.config import FLConfig


class ChannelParams(NamedTuple):
    sigma2: torch.Tensor       # (C,)
    h_threshold: torch.Tensor  # ()
    noise_std: torch.Tensor    # ()
    ota_on: torch.Tensor       # () 1.0 | 0.0
    fgn_on: torch.Tensor       # () 1.0 | 0.0


def channel_params(fl: FLConfig, device="cpu",
                   n_clusters: Optional[int] = None) -> ChannelParams:
    """The channel knobs of a static ``FLConfig`` as float32 tensors, for
    ``n_clusters`` clusters (default ``fl.n_clusters``; the distributed
    step passes its mesh's cluster count)."""
    c = fl.n_clusters if n_clusters is None else n_clusters

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)
    return ChannelParams(
        sigma2=f32([fl.cluster_sigma2(i) for i in range(c)]),
        h_threshold=f32(fl.h_threshold),
        noise_std=f32(fl.noise_std),
        ota_on=f32(1.0 if fl.ota else 0.0),
        fgn_on=f32(1.0 if fl.weighting == "fedgradnorm" else 0.0),
    )


def stack_channel_params(chans: Sequence[ChannelParams]) -> ChannelParams:
    """Stack S scenarios into one bank with a leading (S,) axis on every
    field."""
    if not chans:
        raise ValueError("empty scenario list")
    return ChannelParams(*[torch.stack(fields) for fields in zip(*chans)])


def scenario_channel(bank: ChannelParams, s: int) -> ChannelParams:
    """Scenario ``s``'s knobs: row ``s`` of every field of a stacked bank."""
    return ChannelParams(*[field[s] for field in bank])


def cluster_channel(chan: ChannelParams, cluster: int) -> ChannelParams:
    """One cluster's view: σ² narrowed from (C,) to that cluster's ()."""
    return chan._replace(sigma2=chan.sigma2[cluster])
