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

Scenarios may vary only the knobs that are tensors in the round: the
channel's (``sigma2``, ``h_threshold``, ``noise_std``, ``ota``,
``weighting``) and, on a bank whose base config has ``faults=True``, the
fault knobs (``dropout_rate``, ``blackout_rate``, ``straggler_rate``,
``staleness_rounds``, ``spike_norm``, or a ``FaultParams`` scenario).
Every other ``FLConfig`` field is static and the bank rejects a scenario
that differs in one. The participation draw depends on the shared round
key only, so a fault sweep compares the rates on common random numbers.

``save``/``restore`` checkpoint the whole (S,)-banked state in the
reference's format (``repro_torch.checkpoint.store``), with the scenario
count and the packed layout pinned in the manifest (DESIGN.md §3.9,
§3.13), so a bank continues bit for bit across a restore, and a
checkpoint of the reference's bank restores here and the other way
round.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Sequence, Tuple, Union

import torch

from repro_torch.checkpoint.store import (
    checkpoint_metadata, restore_checkpoint, save_checkpoint,
)
from repro_torch.common.config import FLConfig
from repro_torch.common.layout_tune import layout_of
from repro_torch.common.tree import state_map
from repro_torch.core.channel import (
    ChannelParams, FaultParams, channel_params, fault_params,
    scenario_channel, scenario_faults, stack_channel_params,
    stack_fault_params,
)
from repro_torch.core.sim import HotaSim, SimState

# the ONLY FLConfig fields a scenario may vary (the reference's set): the
# fault knobs are traced values there, but ``faults`` itself is static
_FAULT_FIELDS = ("dropout_rate", "blackout_rate", "straggler_rate",
                 "staleness_rounds", "spike_norm")
TRACED_FIELDS = frozenset(
    {"sigma2", "h_threshold", "noise_std", "ota", "weighting",
     *_FAULT_FIELDS})

Scenario = Union[FLConfig, ChannelParams, FaultParams, Dict[str, Any]]


def _as_channel_params(sc: Scenario, base: FLConfig,
                       device="cpu") -> ChannelParams:
    """One scenario's channel knobs on ``device`` (a ``FaultParams``
    scenario runs the base channel). Raises for a static field that
    differs from ``base``."""
    if isinstance(sc, ChannelParams):
        if tuple(sc.sigma2.shape) != (base.n_clusters,):
            raise ValueError(
                f"scenario sigma2 shape {tuple(sc.sigma2.shape)} != "
                f"(n_clusters,) = ({base.n_clusters},)")
        return ChannelParams(*[torch.as_tensor(f, dtype=torch.float32)
                               .to(device) for f in sc])
    if isinstance(sc, FaultParams):
        return channel_params(base, device=device)
    if isinstance(sc, dict):
        sc = dataclasses.replace(base, **sc)
    if not isinstance(sc, FLConfig):
        raise TypeError(f"scenario must be FLConfig | ChannelParams | "
                        f"FaultParams | dict of FLConfig overrides, got "
                        f"{type(sc)}")
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
    return channel_params(sc, device=device)


def _as_fault_params(sc: Scenario, base: FLConfig,
                     device="cpu") -> FaultParams:
    """One scenario's fault knobs on ``device``; a channel-only scenario
    takes the base config's. Raises, as the reference does, for a
    ``FaultParams`` scenario or a varied fault knob on a bank whose base
    config has ``faults=False`` (the knob would be silently inert)."""
    if isinstance(sc, FaultParams):
        if not base.faults:
            raise ValueError(
                "FaultParams scenario in a bank whose base config has "
                "faults=False — the fault gate is static (it changes the "
                "round), so build the bank from a faults=True base")
        return FaultParams(*[torch.as_tensor(f, dtype=torch.float32)
                             .to(device) for f in sc])
    if isinstance(sc, ChannelParams):
        return fault_params(base, device=device)
    if isinstance(sc, dict):
        sc = dataclasses.replace(base, **sc)
    if not base.faults:
        for f in _FAULT_FIELDS:
            if getattr(sc, f) != getattr(base, f):
                raise ValueError(
                    f"scenario varies fault knob {f!r} but the bank's base "
                    f"config has faults=False — the knob would be silently "
                    f"inert; build the bank from a faults=True base")
    return fault_params(sc, device=device)


class ScenarioBank:
    """An (S,)-batched bank of channel (and fault) scenarios over one
    ``HotaSim``.

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
        # with faults=False the round never reads the fault knobs
        self.fault_bank = stack_fault_params(
            [_as_fault_params(sc, sim.fl, sim.device) for sc in scenarios])
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
                ota_bits_mode="supplied", streams=streams,
                faults=scenario_faults(self.fault_bank, s))
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

    # ------------------------------------------------------------------
    def _layout_metadata(self) -> Dict[str, Any]:
        """The bank's packed-layout pin (DESIGN.md §3.13): the section
        folds, and so every channel stream, depend on the layout."""
        return layout_of(self.sim.fl).to_metadata()

    def save(self, ckpt_dir: str, step: int, states: SimState) -> str:
        """Write the banked state to ``<ckpt_dir>/step_<step>`` with the
        scenario count and the layout in the manifest; returns the
        path."""
        return save_checkpoint(
            ckpt_dir, step, states,
            {"kind": type(self).__name__, "n_scenarios": self.n_scenarios,
             "layout": self._layout_metadata()})

    def restore(self, ckpt_dir: str, step: int) -> SimState:
        """The banked state saved at ``step``, shape-checked against this
        bank's and placed on its device. Raises if the checkpoint pins
        another scenario count or another packed layout (the streams
        would silently change)."""
        s = checkpoint_metadata(ckpt_dir, step).get("n_scenarios")
        if s is not None and s != self.n_scenarios:
            raise ValueError(
                f"checkpoint at step {step} was saved from a {s}-scenario "
                f"bank but this bank has S={self.n_scenarios} — a bank "
                f"only restores states with a matching scenario axis")
        like = state_map(
            lambda t: torch.empty((self.n_scenarios,) + tuple(t.shape),
                                  dtype=t.dtype, device="meta"),
            self.sim.abstract_state())
        return restore_checkpoint(ckpt_dir, step, like,
                                  device=self.sim.device,
                                  expected_layout=self._layout_metadata())
