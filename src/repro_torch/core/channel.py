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

``FaultParams`` is the same pattern for the fault-injection knobs
(DESIGN.md §3.14): dropout, blackout and straggler rates, the staleness
depth, the guard's spike threshold and the ``faults_on`` gate are
tensors, banked along (S,) by ``stack_fault_params``; ``FLConfig.faults``
is the one static gate that decides whether a round reads them.
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


class FaultParams(NamedTuple):
    """The fault-injection knobs as tensors (DESIGN.md §3.14). The
    participation draw compares shared uniforms against these rates, so
    changing a rate moves no channel stream."""
    dropout: torch.Tensor     # () per-client drop probability
    blackout: torch.Tensor    # () per-cluster blackout probability
    straggler: torch.Tensor   # () per-client straggler probability
    staleness: torch.Tensor   # () straggler staleness depth τ (rounds)
    spike_norm: torch.Tensor  # () guard threshold on ‖ĝ‖ (inf = off)
    faults_on: torch.Tensor   # () 1.0 = inject faults, 0.0 = none


def fault_params(fl: FLConfig, device="cpu") -> FaultParams:
    """The fault knobs of a static ``FLConfig`` as float32 tensors."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)
    return FaultParams(
        dropout=f32(fl.dropout_rate),
        blackout=f32(fl.blackout_rate),
        straggler=f32(fl.straggler_rate),
        staleness=f32(float(fl.staleness_rounds)),
        spike_norm=f32(fl.spike_norm),
        faults_on=f32(1.0 if fl.faults else 0.0),
    )


def stack_fault_params(faults: Sequence[FaultParams]) -> FaultParams:
    """Stack S fault scenarios into one bank with a leading (S,) axis."""
    if not faults:
        raise ValueError("empty fault-scenario list")
    return FaultParams(*[torch.stack(fields) for fields in zip(*faults)])


def scenario_faults(bank: FaultParams, s: int) -> FaultParams:
    """Scenario ``s``'s fault knobs: row ``s`` of every field."""
    return FaultParams(*[field[s] for field in bank])
