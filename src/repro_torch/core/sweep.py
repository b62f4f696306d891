"""ScenarioBank: one sweep over several channel scenarios.

Port of ``ScenarioBank`` from ``repro.core.sweep``. The paper's Figs. 2-4
compare channel scenarios (dynamic vs. equal weighting, one bad cluster,
diverse σ²). The bank stacks the scenarios' channel knobs
(``ChannelParams``) along a leading (S,) axis, keeps one state per
scenario along the same axis, and runs ``HotaSim.step_with_channel`` for
every scenario each round:

* the batch and the round key are shared by all scenarios (common random
  numbers): every scenario sees the same data order, the same stream
  words (thresholded against its own σ²) and the same AWGN, so paired
  contrasts such as Fig. 2's are variance-reduced;
* states and metrics carry the reference's leading (S,) axis.

The reference vmaps the step over the scenarios; here the scenarios run
one after another on views of the banked state, and the new states are
stacked again. On the client-folded engine the round's streams are drawn
once per round and read by every scenario (the reference's
``ota_bits_mode="supplied"``): the draw is the largest part of a round.
The streaming and sectioned engines draw inside each scenario's step, one
cluster or one section at a time, since drawing every cluster's or every
section's streams up front is the memory their contract rules out.

Scenarios may vary only the traced knobs (``sigma2``, ``h_threshold``,
``noise_std``, ``ota``, ``weighting``); every other ``FLConfig`` field is
static and the bank rejects a scenario that differs in one. The fault
knobs are traced in the reference too, but faults are not ported yet, so
a scenario that varies one is refused.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Sequence, Tuple, Union

import torch

from repro_torch.common.config import FLConfig
from repro_torch.common.tree import state_map
from repro_torch.core.channel import (
    ChannelParams, channel_params, scenario_channel, stack_channel_params,
)
from repro_torch.core.sim import HotaSim, SimState

# the ONLY FLConfig fields a scenario may vary (the reference's set): the
# fault knobs are traced values there, but ``faults`` itself is static
_FAULT_FIELDS = ("dropout_rate", "blackout_rate", "straggler_rate",
                 "staleness_rounds", "spike_norm")
TRACED_FIELDS = frozenset(
    {"sigma2", "h_threshold", "noise_std", "ota", "weighting",
     *_FAULT_FIELDS})

Scenario = Union[FLConfig, ChannelParams, Dict[str, Any]]


def _as_channel_params(sc: Scenario, base: FLConfig,
                       device="cpu") -> ChannelParams:
    """One scenario's channel knobs on ``device``. Raises for a static
    field that differs from ``base`` and for a fault knob that differs
    (faults are not ported)."""
    if isinstance(sc, ChannelParams):
        if tuple(sc.sigma2.shape) != (base.n_clusters,):
            raise ValueError(
                f"scenario sigma2 shape {tuple(sc.sigma2.shape)} != "
                f"(n_clusters,) = ({base.n_clusters},)")
        return ChannelParams(*[torch.as_tensor(f, dtype=torch.float32)
                               .to(device) for f in sc])
    if isinstance(sc, dict):
        sc = dataclasses.replace(base, **sc)
    if not isinstance(sc, FLConfig):
        raise TypeError(f"scenario must be FLConfig | ChannelParams | dict "
                        f"of FLConfig overrides, got {type(sc)} (fault "
                        f"scenarios wait for the port of faults)")
    for f in dataclasses.fields(FLConfig):
        if f.name in TRACED_FIELDS:
            continue
        sc_val, base_val = getattr(sc, f.name), getattr(base, f.name)
        if sc_val != base_val:
            raise ValueError(
                f"scenario field {f.name!r} differs from the bank's base "
                f"config: scenario has {f.name}={sc_val!r}, base has "
                f"{f.name}={base_val!r}; only traced knobs "
                f"{sorted(TRACED_FIELDS)} may vary within a ScenarioBank — "
                f"build a second bank for static changes")
    for f in _FAULT_FIELDS:
        if getattr(sc, f) != getattr(base, f):
            raise ValueError(
                f"scenario varies fault knob {f!r}: faults are not ported "
                f"to repro_torch yet, so the knob would be silently inert")
    return channel_params(sc, device=device)


class ScenarioBank:
    """An (S,)-batched bank of channel scenarios over one ``HotaSim``.

    >>> bank = ScenarioBank(sim, [dict(weighting="equal"),
    ...                           dict(sigma2=(0.05, 1.0)), base_fl])
    >>> states = bank.init(rng.PRNGKey(0))
    >>> states, m = bank.step(states, xb, yb, rng.PRNGKey(1))
    >>> m["loss"].shape      # (S, C, N)
    """

    def __init__(self, sim: HotaSim, scenarios: Sequence[Scenario]):
        self.sim = sim
        self.chan_bank = stack_channel_params(
            [_as_channel_params(sc, sim.fl, sim.device) for sc in scenarios])
        self.n_scenarios = int(self.chan_bank.ota_on.shape[0])

    # ------------------------------------------------------------------
    def init(self, key) -> SimState:
        """(S,)-batched initial state: every scenario starts from the SAME
        state, ``sim.init(key)`` (common random numbers extend to init)."""
        s = self.n_scenarios
        return state_map(
            lambda x: x.unsqueeze(0).repeat((s,) + (1,) * x.dim()),
            self.sim.init(key))

    def scenario_state(self, states: SimState, s: int) -> SimState:
        """Scenario ``s``'s unbatched state: views of the bank's tensors."""
        return state_map(lambda x: x[s], states)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self, states: SimState, xb, yb, key):
        """One Alg.-1 round for every scenario. ``xb``/``yb``/``key`` are
        unbatched and shared across scenarios (common random numbers);
        states and the returned metrics carry the leading (S,) axis."""
        sim = self.sim
        x = torch.as_tensor(xb, dtype=torch.float32).to(sim.device)
        y = torch.as_tensor(yb).to(device=sim.device, dtype=torch.int64)
        streams = None
        if sim.draws_streams_at_once:
            streams = sim.round_streams(
                key, self.scenario_state(states.omega, 0))
        new, metrics = [], []
        for s in range(self.n_scenarios):
            st, m = sim.step_with_channel(
                self.scenario_state(states, s), x, y, key,
                scenario_channel(self.chan_bank, s),
                ota_bits_mode="supplied", streams=streams)
            new.append(st)
            metrics.append(m)
        return (state_map(lambda *xs: torch.stack(xs), *new),
                {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]})

    # ------------------------------------------------------------------
    def run(self, states: SimState, batches: Iterable[Tuple[Any, Any]],
            keys: Sequence[Any]):
        """Drive the bank over (x, y) batches and round keys; returns the
        final states and the metrics stacked along a leading time axis:
        (T, S, ...)."""
        history: List[Dict[str, torch.Tensor]] = []
        for (x, y), k in zip(batches, keys):
            states, m = self.step(states, x, y, k)
            history.append(m)
        if not history:
            raise ValueError("no batches supplied")
        return states, {k: torch.stack([m[k] for m in history])
                        for k in history[0]}
