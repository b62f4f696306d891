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
one after another on views of the banked state, and the leaves each
round replaces are stacked again. A leaf that a round writes in place
(the population bank of a ``SampledHotaSim``: its scatter updates the
scenario's view of the stacked bank) is kept as it is, so a round over a
sampled sim moves O(C·N) rows of the bank, not the bank, and the step
consumes the input state as the sampled sim's own step does. On the
client-folded engine the round's streams are drawn
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

``ShardedScenarioBank`` (DESIGN.md §3.8) lays the (S,) axis on a 1-D
("scenario",) mesh of processes (``launch.mesh.make_scenario_mesh``):
each rank keeps the (S/n, ...) rows of its scenarios and their knobs,
while batch and key go to every rank unchanged, so each rank's streams
are word for word the one-process bank's; ``step`` returns the global
(S, ...) metrics after one all-gather over "scenario". On one card the
ranks are processes that share it, each dispatching its own scenarios.

``DistScenarioBank`` (DESIGN.md §3.10) sweeps the distributed step
(``core.hota_step``) on a ("scenario", "cluster", "client") mesh
(``launch.mesh.make_dist_scenario_mesh``): each scenario row runs its
S/n_rows scenarios one after another through the round body, whose
collectives stay on the row's FL axes. Where the reference vmaps the
body, so that each collective carries all of a row's scenarios, the
loop sends each collective once per scenario. Nothing in the step
reads a scenario coordinate (the channel keys fold step, section,
cluster and chunk), so a scenario's trajectory does not depend on the
row it runs on.

``save``/``restore`` checkpoint the whole (S,)-banked state in the
reference's format (``repro_torch.checkpoint.store``), with the scenario
count and the packed layout pinned in the manifest (DESIGN.md §3.9,
§3.13), so a bank continues bit for bit across a restore, and a
checkpoint of the reference's bank restores here and the other way
round. The banks on a mesh gather the global state on the mesh's first
rank, which writes it, and every rank restores its own rows from the
file, so a checkpoint moves between placements.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Sequence, Tuple, Union

import torch

from repro_torch.checkpoint.store import (
    _step_dir, checkpoint_metadata, restore_checkpoint, save_checkpoint,
)
from repro_torch.common.config import FLConfig
from repro_torch.common.layout_tune import layout_of
from repro_torch.common.spans import span
from repro_torch.common.tree import state_map
from repro_torch.core.channel import (
    ChannelParams, FaultParams, channel_params, fault_params,
    scenario_channel, scenario_faults, stack_channel_params,
    stack_fault_params,
)
from repro_torch.core.hota import _mesh_client_axes
from repro_torch.core.hota_step import (
    gather_state, global_like, make_hota_step_parts, shard_state,
)
from repro_torch.core.sampling import SampledHotaSim, SampledSimState
from repro_torch.core.sim import HotaSim, SimState
from repro_torch.launch.mesh import (
    make_dist_scenario_mesh, make_scenario_mesh,
)
from repro_torch.sharding import collectives as col
from repro_torch.sharding.mesh_utils import (
    SCENARIO_AXIS, Mesh, bank_rows, prepend_axis, scenario_axis_size,
    scenario_banked_tree,
)

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


def _restack(stacked: torch.Tensor, *rows: torch.Tensor) -> torch.Tensor:
    """One leaf of the bank after a round: ``stacked`` itself where every
    scenario's new value is its own view of it (written in place), else
    the scenarios' new values stacked."""
    if all(r.data_ptr() == v.data_ptr() and r.shape == v.shape
           and r.stride() == v.stride()
           for r, v in zip(rows, stacked.unbind(0))):
        return stacked
    return torch.stack(rows)


def _row(states, s: int):
    """Row ``s`` of a banked state: views of its tensors."""
    return state_map(lambda x: x[s], states)


def _repeat(state, n: int):
    """A state repeated along a new leading axis of ``n`` rows."""
    return state_map(lambda x: x.unsqueeze(0).repeat((n,) + (1,) * x.dim()),
                     state)


def _bank_slice(bank, rows: slice):
    """The rows of a stacked knob bank (``ChannelParams`` or
    ``FaultParams``) that a rank holds."""
    return type(bank)(*[field[rows] for field in bank])


def _check_scenario_count(ckpt_dir: str, step: int, n_scenarios: int):
    s = checkpoint_metadata(ckpt_dir, step).get("n_scenarios")
    if s is not None and s != n_scenarios:
        raise ValueError(
            f"checkpoint at step {step} was saved from a {s}-scenario "
            f"bank but this bank has S={n_scenarios} — a bank only "
            f"restores states with a matching scenario axis")


def check_scenario_split(n_scenarios: int, n_ranks: int) -> None:
    """Refuse a scenario mesh of ``n_ranks`` that does not divide the
    bank's S evenly (the reference's refusal, word for word)."""
    if n_scenarios % n_ranks:
        raise ValueError(
            f"scenario count S={n_scenarios} must divide evenly "
            f"over the {n_ranks}-device scenario mesh — pad the bank or "
            f"shrink the mesh (make_scenario_mesh(n_ranks=...))")


def _step_rows(states, n_local: int, step_row):
    """``step_row(state_s, s)`` for each of the ``n_local`` scenarios a
    process holds, on views of the stacks, one after the other; returns
    the restacked states and the (n_local, ...) metrics."""
    new, metrics = [], []
    for s in range(n_local):
        st, m = step_row(_row(states, s), s)
        new.append(st)
        metrics.append(m)
    return (state_map(_restack, states, *new),
            {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]})


def _gather_metrics(metrics: Dict[str, torch.Tensor], mesh: Mesh):
    """A rank's (S/n, ...) metric rows as the global (S, ...) ones, in one
    all-gather over "scenario" (collective)."""
    names = list(metrics)
    return dict(zip(names, col.all_gather_rows(
        [metrics[k] for k in names], mesh, SCENARIO_AXIS)))


def _owner_row(states, s: int, n_scenarios: int, n_local: int,
               mesh: Mesh):
    """Scenario ``s``'s unbatched state, from the rank that holds it to
    every rank along "scenario" (collective)."""
    if not 0 <= s < n_scenarios:
        raise IndexError(f"scenario {s} is not in a bank of "
                         f"{n_scenarios}")
    owner, row = divmod(s, n_local)
    return state_map(lambda x: col.broadcast(x[row], mesh, SCENARIO_AXIS,
                                             owner), states)


def _manifest(bank) -> Dict[str, Any]:
    """A bank checkpoint's metadata: its kind, scenario count and packed
    layout (the reference's keys)."""
    return {"kind": type(bank).__name__, "n_scenarios": bank.n_scenarios,
            "layout": bank._layout_metadata()}


def _write_on_first_rank(mesh: Mesh, ckpt_dir: str, step: int, tree,
                         metadata) -> str:
    """The mesh's first rank writes ``tree``; then every rank of the mesh
    meets at a barrier, so no rank reads the checkpoint before it
    exists."""
    if mesh.rank == 0:
        save_checkpoint(ckpt_dir, step, tree, metadata)
    if mesh.groups is not None:
        torch.distributed.barrier(group=mesh.group(mesh.axis_names)[0])
    return _step_dir(ckpt_dir, step)


class ScenarioBank:
    """An (S,)-batched bank of channel (and fault) scenarios over one
    ``HotaSim`` or ``SampledHotaSim``.

    >>> bank = ScenarioBank(sim, [dict(weighting="equal"),
    ...                           dict(sigma2=(0.05, 1.0)), base_fl])
    >>> states = bank.init(rng.PRNGKey(0))
    >>> states, m = bank.step(states, xb, yb, rng.PRNGKey(1))
    >>> m["loss"].shape      # (S, C, N)
    """

    def __init__(self, sim: Union[HotaSim, SampledHotaSim],
                 scenarios: Sequence[Scenario]):
        self.sim = sim
        self.chan_bank = stack_channel_params(
            [_as_channel_params(sc, sim.fl, sim.device) for sc in scenarios])
        # with faults=False the round never reads the fault knobs
        self.fault_bank = stack_fault_params(
            [_as_fault_params(sc, sim.fl, sim.device) for sc in scenarios])
        self.n_scenarios = int(self.chan_bank.ota_on.shape[0])
        self.n_local = self.n_scenarios     # the rows this process holds

    # ------------------------------------------------------------------
    def init(self, key) -> SimState:
        """(S,)-batched initial state: every scenario starts from the SAME
        state, ``sim.init(key)`` (common random numbers extend to init)."""
        return _repeat(self.sim.init(key), self.n_local)

    def scenario_state(self, states: SimState, s: int) -> SimState:
        """Scenario ``s``'s unbatched state: views of the bank's tensors."""
        return _row(states, s)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self, states: SimState, xb, yb, key):
        """One Alg.-1 round for every scenario. ``xb``/``yb``/``key`` are
        unbatched and shared across scenarios (common random numbers);
        states and the returned metrics carry the leading (S,) axis."""
        sim = self.sim
        with span("bank.step"):
            x = torch.as_tensor(xb, dtype=torch.float32).to(sim.device)
            y = torch.as_tensor(yb).to(device=sim.device, dtype=torch.int64)
            streams = None
            if sim.draws_streams_at_once:
                inner = states.sim if isinstance(states, SampledSimState) \
                    else states
                streams = sim.round_streams(key, _row(inner.omega, 0))
            states, metrics = _step_rows(
                states, self.n_local, lambda st, s: sim.step_with_channel(
                    st, x, y, key, scenario_channel(self.chan_bank, s),
                    ota_bits_mode="supplied", streams=streams,
                    faults=scenario_faults(self.fault_bank, s)))
            return states, self._metrics(metrics)

    def _metrics(self, metrics: Dict[str, torch.Tensor]):
        """The round's metrics as ``step`` returns them."""
        return metrics

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
        return save_checkpoint(ckpt_dir, step, states, _manifest(self))

    def restore(self, ckpt_dir: str, step: int) -> SimState:
        """The banked state saved at ``step``, shape-checked against this
        bank's and placed on its device. Raises if the checkpoint pins
        another scenario count or another packed layout (the streams
        would silently change)."""
        _check_scenario_count(ckpt_dir, step, self.n_scenarios)
        like = state_map(
            lambda t: torch.empty((self.n_scenarios,) + tuple(t.shape),
                                  dtype=t.dtype, device="meta"),
            self.sim.abstract_state())
        return self._place(restore_checkpoint(
            ckpt_dir, step, like, device="cpu",
            expected_layout=self._layout_metadata()))

    def _place(self, whole: SimState) -> SimState:
        """This process's rows of a restored global state, on its device."""
        return state_map(lambda t: t.to(self.sim.device), whole)


class ShardedScenarioBank(ScenarioBank):
    """A ``ScenarioBank`` whose (S,) axis is split over a "scenario" mesh.

    Each rank holds the (S/n, ...) rows of its scenarios, with their
    channel and fault knobs, and runs the bank's round on them; the
    batch and key reach every rank unchanged (common random numbers
    across ranks: each rank draws the round's streams from the shared
    key, word for word what the one-process bank draws). ``step``
    returns the rank's states and the global (S, ...) metrics. Over a
    ``SampledHotaSim`` each rank holds only its scenarios' population
    banks, written in place.

    >>> mesh = make_scenario_mesh()               # repro_torch.launch.mesh
    >>> bank = ShardedScenarioBank(sim, scenarios, mesh)
    >>> states = bank.init(rng.PRNGKey(0))        # leaves (S/n, ...)
    >>> states, m = bank.step(states, xb, yb, key)  # m: (S, C, N)
    """

    def __init__(self, sim: Union[HotaSim, SampledHotaSim],
                 scenarios: Sequence[Scenario], mesh: Mesh = None):
        super().__init__(sim, scenarios)
        if mesh is None:
            mesh = make_scenario_mesh(device=sim.device)
        n = scenario_axis_size(mesh)
        check_scenario_split(self.n_scenarios, n)
        self.mesh = mesh
        self.n_local = self.n_scenarios // n
        self._rows = bank_rows(self.n_scenarios, mesh)
        self.chan_bank = _bank_slice(self.chan_bank, self._rows)
        self.fault_bank = _bank_slice(self.fault_bank, self._rows)

    def _metrics(self, metrics):
        return _gather_metrics(metrics, self.mesh)

    def scenario_state(self, states: SimState, s: int) -> SimState:
        """Scenario ``s``'s (a global index) unbatched state on every rank.
        A collective: every rank of the mesh calls it with the same ``s``,
        and the rank that holds the scenario broadcasts it."""
        return _owner_row(states, s, self.n_scenarios, self.n_local,
                          self.mesh)

    def save(self, ckpt_dir: str, step: int, states: SimState) -> str:
        """Gather the global (S, ...) state on the mesh's first rank, which
        writes it (the one-process bank's checkpoint); every rank returns
        the path after a barrier. A collective: every rank calls it."""
        whole = state_map(lambda x: col.gather_to_host(
            x, self.mesh, SCENARIO_AXIS, 0), states)
        return _write_on_first_rank(self.mesh, ckpt_dir, step, whole,
                                    _manifest(self))

    def _place(self, whole: SimState) -> SimState:
        """Every rank reads the whole checkpoint and keeps its rows."""
        return state_map(lambda t: t[self._rows].to(self.sim.device,
                                                    copy=True), whole)


class DistScenarioBank:
    """The distributed step over a bank of scenarios, on a ("scenario",
    "cluster", "client") mesh.

    One ``make_hota_step_parts`` on the rank's FL row; the rank keeps
    (S/n_rows, ...) stacks of its FSDP shards and the knobs of its row's
    scenarios, and ``step`` runs those scenarios one after the other on
    views of the stacks through the traced round body (``fast=False``,
    as the reference's vmapped body), so every scenario takes the same
    code whatever its weighting. Each scenario equals the 1-D step run
    with that scenario's ``chan`` on the same ranks, bit for bit, and a
    bank on n rows equals the bank on one. ``tokens``/``labels`` are the
    rank's own batch, as the 1-D step takes them, and the key is shared:
    common random numbers across scenarios and rows. With
    ``fl.faults=True`` a scenario may vary the fault knobs (a fault bank).

    >>> mesh = make_dist_scenario_mesh(n_clusters=1, n_clients=2)
    >>> bank = DistScenarioBank(model, fl, tcfg, scenarios, mesh,
    ...                         loss_kind="cls", n_out=8)
    >>> states = bank.init(rng.PRNGKey(0))
    >>> states, m = bank.step(states, tokens, labels, key)  # m: (S,)
    """

    def __init__(self, model, fl: FLConfig, tcfg,
                 scenarios: Sequence[Scenario], mesh: Mesh = None, *,
                 loss_kind: str = "lm", n_out=None, count_mode=None):
        if mesh is None:
            mesh = make_dist_scenario_mesh(fl.n_clusters, fl.n_clients)
        n_rows = scenario_axis_size(mesh)
        self.mesh = mesh
        self.fl = fl
        parts = make_hota_step_parts(model, mesh, fl, tcfg,
                                     loss_kind=loss_kind, n_out=n_out,
                                     count_mode=count_mode)
        if parts.n_total_clusters != fl.n_clusters:
            raise ValueError(
                f"mesh has {parts.n_total_clusters} clusters but "
                f"fl.n_clusters={fl.n_clusters}")
        self._parts = parts
        dev = mesh.device
        chan_bank = stack_channel_params(
            [_as_channel_params(sc, fl, dev) for sc in scenarios])
        fault_bank = stack_fault_params(
            [_as_fault_params(sc, fl, dev) for sc in scenarios])
        self.n_scenarios = int(chan_bank.ota_on.shape[0])
        if self.n_scenarios % n_rows:
            raise ValueError(
                f"scenario count S={self.n_scenarios} must divide evenly "
                f"over the {n_rows}-row scenario axis — pad the bank or "
                f"shrink the mesh")
        self.n_local = self.n_scenarios // n_rows
        rows = bank_rows(self.n_scenarios, mesh)
        self.chan_bank = _bank_slice(chan_bank, rows)
        self.fault_bank = _bank_slice(fault_bank, rows)
        self.state_specs = scenario_banked_tree(parts.state_specs)

    # ------------------------------------------------------------------
    def init(self, key):
        """The rank's (S/n_rows, ...) stack of ``init_fn(key)``: every
        scenario starts from the same state (common random numbers extend
        to init)."""
        return _repeat(self._parts.init_fn(key), self.n_local)

    @torch.no_grad()
    def step(self, states, tokens, labels, key):
        """One distributed Alg.-1 round for each of the row's scenarios,
        one after the other; returns the rank's new stacks and the global
        (S,) metrics (one all-gather over "scenario")."""
        dev = self.mesh.device
        tokens = torch.as_tensor(tokens).to(dev)
        labels = torch.as_tensor(labels).to(dev)
        states, metrics = _step_rows(
            states, self.n_local, lambda st, s: self._parts.step(
                st, tokens, labels, key, scenario_channel(self.chan_bank, s),
                scenario_faults(self.fault_bank, s)))
        return states, _gather_metrics(metrics, self.mesh)

    def scenario_state(self, states, s: int):
        """Scenario ``s``'s (a global index) unbatched state: on every rank
        its FL shards, as the 1-D step holds them there. A collective:
        every rank of the mesh calls it with the same ``s``."""
        return _owner_row(states, s, self.n_scenarios, self.n_local,
                          self.mesh)

    # ------------------------------------------------------------------
    def _layout_metadata(self) -> Dict[str, Any]:
        return layout_of(self.fl).to_metadata()

    def save(self, ckpt_dir: str, step: int, states) -> str:
        """Gather the global (S, ...) HotaState (the reference bank's
        layout) on the mesh's first rank, which writes it; every rank
        returns the path after a barrier. A collective: every rank of the
        mesh calls it."""
        parts = self._parts
        rowwise = gather_state(states, prepend_axis(parts.state_specs, None),
                               self.mesh)
        whole = None
        if self.mesh.axis_index(_mesh_client_axes(self.mesh)) == 0:
            whole = state_map(lambda x: col.gather_to_host(
                x, self.mesh, SCENARIO_AXIS, 0), rowwise)
        return _write_on_first_rank(self.mesh, ckpt_dir, step, whole,
                                    _manifest(self))

    def restore(self, ckpt_dir: str, step: int):
        """The rank's stacks of the global state saved at ``step`` (by
        this bank on any placement, or by the reference's bank). Every
        rank reads the file and keeps its rows and shards. Raises if the
        checkpoint pins another scenario count or packed layout."""
        _check_scenario_count(ckpt_dir, step, self.n_scenarios)
        parts = self._parts
        like = state_map(
            lambda t: torch.empty((self.n_scenarios,) + tuple(t.shape),
                                  dtype=t.dtype, device="meta"),
            global_like(parts.abstract_fn(), parts.state_specs, self.mesh))
        whole = restore_checkpoint(ckpt_dir, step, like, device="cpu",
                                   expected_layout=self._layout_metadata())
        return shard_state(whole, self.state_specs, self.mesh,
                           device=self.mesh.device)
