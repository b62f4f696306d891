"""Per-round client sampling from a population bank (DESIGN.md §3.15).

Port of ``repro.core.sampling``. A real round draws a few participants
from a large enrolled population, not all C·N clients at once:

* ``ClientBank`` holds the per-client persistent state (personalized
  heads, their Adam moments and step, the FedGradNorm loss baseline f0)
  for M candidates per (cluster, slot) position: leaves (C, N, M, ...).
  A slot is a task, so slot n's subpopulation is the M clients of
  cluster l working task n, and the population is C·N·M.
* ``SampledHotaSim`` wraps ``HotaSim``: each round draws one id per slot
  (``ota.draw_client_sample``, the reserved SAMPLE_FOLD domain), gathers
  the drawn clients' state into the (C, N) slot view, runs the unmodified
  inner round and scatters the slot results back into the bank. The
  subpopulations are disjoint, so no two slots address one bank entry.

Position determinism (DESIGN.md §4): every channel and participation
stream keys off the slot position and a reserved fold, never off the
drawn ids, so resampling or growing the population moves no mask, no
AWGN and no fault draw. A round moves O(C·N) rows of the bank whatever M
is: the gather copies C·N rows out, and the scatter writes them back in
place (``index_copy_``), so the bank is never copied. ``step`` therefore
consumes its input state, as a donated buffer does under JAX.

``SampledHotaSim`` offers the interface ``ScenarioBank`` reads of a
``HotaSim`` (``fl``, ``chan``, ``faults``, ``device``, ``max_classes``,
``init``, ``abstract_state``, ``draws_streams_at_once``,
``round_streams`` and ``step_with_channel`` with its ``streams``), so a
scenario bank over a sampled sim draws the round's streams and ids once
for every scenario.

FedGradNorm under sampling: its state and the loss weights p live at
slot (task) level, while f0 is per client; a never-sampled client's f0 is
the -1 sentinel, latched by its first sampled round.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch import rng
from repro_torch.common.config import FLConfig, TrainConfig
from repro_torch.common.tree import state_map, tree_map
from repro_torch.core import ota
from repro_torch.core.channel import ChannelParams, FaultParams
from repro_torch.core.sim import HotaSim, SimState
from repro_torch.models.model import Model
from repro_torch.models.params import abstract_params, init_params
from repro_torch.optim.adam import AdamState, adam_init


class ClientBank(NamedTuple):
    """Per-client persistent state of the whole population. Leaves carry
    a leading (C, N, M) prefix: cluster × slot (task) × subpopulation."""
    heads: Any               # (C, N, M, ...) personalized heads
    head_opt: AdamState      # step (C, N, M), moments (C, N, M, ...)
    f0: torch.Tensor         # (C, N, M) first-seen loss baseline; -1 unseen


class SampledSimState(NamedTuple):
    """A sampled sim's state: the inner (C, N) slot-view ``SimState``
    (shared model, optimizers, FedGradNorm state, and the slot copies of
    last round's participants) and the population bank."""
    sim: SimState
    bank: ClientBank


def init_client_bank(model: Model, fl: FLConfig, population: int,
                     max_classes: int, key, device="cuda") -> ClientBank:
    """A fresh population on ``device``: every client its own head from
    ``split(key, C·N·M)`` (the reference's per-member keys, as a
    (C, N, M, 2) table), zero Adam moments and step, and the -1 unseen-f0
    sentinel. The heads are drawn a slice of clients at a time
    (``models.params``), so the transient word buffers stay a small
    fraction of the bank."""
    c, n, m = fl.n_clusters, fl.n_clients, int(population)
    keys = rng.split(key, c * n * m).reshape(c, n, m, 2)
    heads = init_params(model.head_specs(max_classes), keys, device=device)
    return ClientBank(heads=heads,
                      head_opt=adam_init(heads, batch_shape=(c, n, m)),
                      f0=-torch.ones((c, n, m), dtype=torch.float32,
                                     device=device))


def _bank_rows(ids: torch.Tensor, population: int) -> torch.Tensor:
    """The (C·N,) rows of a bank leaf viewed (C·N·M, ...) that the
    (C, N) draw ``ids`` selects: row (l·N + n)·M + ids[l, n]."""
    c, n = ids.shape
    slots = torch.arange(c * n, dtype=torch.int64, device=ids.device)
    return slots * population + ids.reshape(-1).to(torch.int64)


def _rows_view(leaf: torch.Tensor) -> torch.Tensor:
    """A (C, N, M, ...) bank leaf viewed (C·N·M, ...), sharing its
    storage (``view`` raises rather than copy a leaf it cannot view)."""
    return leaf.view((-1,) + tuple(leaf.shape[3:]))


def gather_clients(bank: ClientBank, ids: torch.Tensor):
    """(heads, head_opt, f0) slot views of the drawn ids: leaf
    (C, N, M, ...) → (C, N, ...), a copy of C·N rows (one
    ``index_select`` per leaf) however large M is."""
    rows = _bank_rows(ids, bank.f0.shape[2])

    def take(leaf):
        return _rows_view(leaf).index_select(0, rows).view(
            tuple(ids.shape) + tuple(leaf.shape[3:]))
    return (tree_map(take, bank.heads), state_map(take, bank.head_opt),
            take(bank.f0))


def scatter_clients(bank: ClientBank, ids: torch.Tensor, heads, head_opt,
                    f0: torch.Tensor) -> ClientBank:
    """Write the slot results back at the drawn ids, in place: one
    ``index_copy_`` per bank leaf, and the same leaves are returned. Each
    (cluster, slot) owns a disjoint subpopulation and draws one id, so no
    two slots write one entry."""
    rows = _bank_rows(ids, bank.f0.shape[2])

    def put(leaf, val):
        _rows_view(leaf).index_copy_(0, rows, val.reshape(
            (rows.shape[0],) + tuple(leaf.shape[3:])).to(leaf.dtype))
        return leaf
    return ClientBank(heads=tree_map(put, bank.heads, heads),
                      head_opt=state_map(put, bank.head_opt, head_opt),
                      f0=put(bank.f0, f0))


class SampledHotaSim:
    """A ``HotaSim`` whose per-round participants are sampled from a
    ``ClientBank`` population (DESIGN.md §3.15).

    The constructor is ``HotaSim``'s plus ``population`` (M, the
    subpopulation per slot). The inner round is the unmodified
    ``HotaSim.step_with_channel``: faults, staleness, skip rounds, the
    streaming and sectioned engines and the scenario banks all compose,
    sampling being a gather/scatter shell around the slot view."""

    def __init__(self, model: Model, fl: FLConfig, tcfg: TrainConfig,
                 n_classes_per_client, population: int,
                 max_classes: int = None, device="cuda"):
        if population < 1:
            raise ValueError(f"population must be ≥ 1, got {population}")
        self.sim = HotaSim(model, fl, tcfg, n_classes_per_client,
                           max_classes=max_classes, device=device)
        self.population = int(population)
        self.model = model
        self.tcfg = tcfg

    # the interface ScenarioBank reads of a HotaSim
    @property
    def fl(self) -> FLConfig:
        return self.sim.fl

    @property
    def chan(self) -> ChannelParams:
        return self.sim.chan

    @property
    def faults(self) -> FaultParams:
        return self.sim.faults

    @property
    def device(self) -> torch.device:
        return self.sim.device

    @property
    def max_classes(self) -> int:
        return self.sim.max_classes

    @property
    def draws_streams_at_once(self) -> bool:
        return self.sim.draws_streams_at_once

    def round_streams(self, key, omega) -> ota.SectionStreams:
        return self.sim.round_streams(key, omega)

    # ------------------------------------------------------------------
    def init(self, key) -> SampledSimState:
        """The inner ``HotaSim.init(key)`` and a fresh bank from
        ``fold_in(key, SAMPLE_INIT_FOLD)``, as the reference."""
        bank = init_client_bank(self.model, self.fl, self.population,
                                self.max_classes,
                                rng.fold_in(key, ota.SAMPLE_INIT_FOLD),
                                device=self.device)
        return SampledSimState(sim=self.sim.init(key), bank=bank)

    def abstract_state(self) -> SampledSimState:
        """``init``'s shapes and dtypes as storage-free ``meta`` tensors."""
        c, n, m = self.fl.n_clusters, self.fl.n_clients, self.population
        heads = tree_map(lambda t: t.expand((c, n, m) + tuple(t.shape)),
                         abstract_params(self.model.head_specs(
                             self.max_classes)))
        head_opt = AdamState(
            step=torch.empty((c, n, m), dtype=torch.int32, device="meta"),
            mu=heads, nu=heads)
        f0 = torch.empty((c, n, m), dtype=torch.float32, device="meta")
        return SampledSimState(sim=self.sim.abstract_state(),
                               bank=ClientBank(heads=heads,
                                               head_opt=head_opt, f0=f0))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self, state: SampledSimState, xb, yb, key,
             chan: ChannelParams = None, faults: FaultParams = None):
        """One sampled round; ``HotaSim.step``'s contract, and the metrics
        gain ``sample_ids``, the (C, N) draw (a pure function of the round
        key). Consumes ``state``: its bank is written in place."""
        return self.step_with_channel(state, xb, yb, key,
                                      self.chan if chan is None else chan,
                                      faults=faults)

    @torch.no_grad()
    def step_with_channel(self, state: SampledSimState, xb, yb, key,
                          chan: ChannelParams, ota_bits_mode: str = "fused",
                          streams: Optional[ota.SectionStreams] = None,
                          faults: Optional[FaultParams] = None):
        """Draw ids → gather the slot view → the inner round → scatter
        back (in place). A non-participating or frozen slot (the fault
        path) round-trips through the scatter unchanged, so a skipped
        round is the bank's identity bit for bit. ``streams`` and
        ``ota_bits_mode`` pass to the inner round, so a bank draws the
        round's streams once for every scenario."""
        fl = self.fl
        ids = ota.draw_client_sample(key, fl.n_clusters, fl.n_clients,
                                     self.population, self.device)
        heads, head_opt, f0 = gather_clients(state.bank, ids)
        slot_state = state.sim._replace(heads=heads, head_opt=head_opt,
                                        f0=f0)
        new_sim, metrics = self.sim.step_with_channel(
            slot_state, xb, yb, key, chan, ota_bits_mode=ota_bits_mode,
            streams=streams, faults=faults)
        bank = scatter_clients(state.bank, ids, new_sim.heads,
                               new_sim.head_opt, new_sim.f0)
        metrics = dict(metrics, sample_ids=ids)
        return SampledSimState(sim=new_sim, bank=bank), metrics
