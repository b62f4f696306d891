"""Section-layout autotuner for the packed OTA engines.

Port of ``repro.common.layout_tune`` (DESIGN.md §3.13). The section
layout decides the stream folds, so every channel draw, and how much of
each 131072-word chunk a small section draws and throws away; which
layout and engine is fastest depends on the template and the device.
This module makes the choice once per (template, C, N, device):

* ``calibrate_layout`` times every candidate on synthetic gradients: the
  ``"toplevel"`` layout at each coalescing threshold on the client-folded
  ("slab") and the sectioned engine, the legacy two-section ``"tail"``
  layout, a sectioned candidate sized to ``memory_budget_bytes`` when one
  is given, and the per-leaf oracle. On the card a candidate's time is
  the host clock around calls that end in ``torch.cuda.synchronize()``.
* ``tune_layout`` caches the winner in memory and on disk, in the port's
  own file (``DEFAULT_CACHE_PATH`` under the checkout's ``build/``, or
  ``$REPRO_TORCH_LAYOUT_CACHE``; "" turns persistence off). The JAX
  package keeps its own cache: a card's timings never choose a layout for
  it. The disk key (``template_hash``) digests the template's leaf paths,
  shapes and dtypes, the topology, the candidate set and the device.
* ``apply_layout`` / ``tuned_fl`` write the choice into ``FLConfig``.
  ``LayoutChoice.to_metadata`` gives the reference's keys and values, so a
  checkpoint manifest written by either package reads in the other.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import rng
from repro_torch.common.config import FLConfig
from repro_torch.common.device import resolve_device
from repro_torch.common.flatpack import packer_for
from repro_torch.common.tree import (
    tree_flatten_with_path, tree_map, tree_unflatten,
)
from repro_torch.kernels.slab import LANE

# threshold sweep, in slab rows (x128 lanes): 0 = uncoalesced; 1024 rows
# = one full stream chunk, past which coalescing saves no more draw
DEFAULT_THRESHOLDS: Tuple[int, ...] = (0, 64, 256, 1024)

# every engine a LayoutChoice may name
ENGINES: Tuple[str, ...] = ("slab", "sectioned", "perleaf")

DEFAULT_CACHE_PATH = str(Path(__file__).resolve().parents[3] / "build"
                         / "layout_tune.json")
CACHE_ENV = "REPRO_TORCH_LAYOUT_CACHE"


class LayoutUnavailableError(ValueError):
    """A LayoutChoice names an engine/section combination the FLConfig
    gates cannot run (a stale cache entry, a foreign manifest)."""


class LayoutBudgetError(ValueError):
    """``memory_budget_bytes`` excluded every candidate layout."""


class LayoutChoice(NamedTuple):
    """One tuned packed-layout decision: the unit a manifest pins."""
    engine: str             # "slab" | "sectioned" | "perleaf"
    sections: str           # "toplevel" | "tail" (legacy two-section)
    min_section_rows: int   # coalescing threshold (slab rows; 0 = off)
    max_section_rows: int = 0   # section split cap (slab rows; 0 = off)

    def to_metadata(self) -> Dict[str, Any]:
        md = {"engine": self.engine, "sections": self.sections,
              "min_section_rows": int(self.min_section_rows)}
        # only when set, as the reference writes it
        if self.max_section_rows:
            md["max_section_rows"] = int(self.max_section_rows)
        return md

    @classmethod
    def from_metadata(cls, md: Dict[str, Any]) -> "LayoutChoice":
        choice = cls(str(md["engine"]), str(md["sections"]),
                     int(md["min_section_rows"]),
                     int(md.get("max_section_rows", 0)))
        _check_available(choice)
        return choice

    def describe(self) -> str:
        if self.engine == "perleaf":
            return "perleaf"
        desc = (f"{self.engine}/sections={self.sections}"
                f"/min_section_rows={self.min_section_rows}")
        if self.max_section_rows:
            desc += f"/max_section_rows={self.max_section_rows}"
        return desc


def _check_available(choice: LayoutChoice) -> None:
    """Raise LayoutUnavailableError unless ``choice`` names a runnable
    engine/layout combination (the reference's rules)."""
    if choice.engine not in ENGINES:
        raise LayoutUnavailableError(
            f"layout names unknown engine {choice.engine!r} (known: "
            f"{', '.join(ENGINES)}): a stale or foreign layout-tune cache or "
            f"checkpoint entry; re-tune the layout")
    if choice.engine == "sectioned" and choice.sections != "toplevel":
        raise LayoutUnavailableError(
            f"layout {choice.describe()} is unavailable: the sectioned "
            f"engine streams the multi-section layout and requires "
            f"sections='toplevel'; the {choice.sections!r} layout has no "
            f"section structure to stream")
    if choice.engine == "perleaf" and (choice.min_section_rows
                                       or choice.max_section_rows):
        raise LayoutUnavailableError(
            f"layout {choice.describe()} is unavailable: the per-leaf "
            f"engine has no packed sections, so min/max_section_rows would "
            f"be silently inert")
    if choice.max_section_rows < 0:
        raise LayoutUnavailableError(
            f"layout {choice.describe()} is unavailable: max_section_rows "
            f"must be >= 0")
    if 0 < choice.max_section_rows < choice.min_section_rows:
        raise LayoutUnavailableError(
            f"layout {choice.describe()} is unavailable: max_section_rows < "
            f"min_section_rows cannot be packed")


def layout_of(fl: FLConfig) -> LayoutChoice:
    """The LayoutChoice an FLConfig encodes."""
    if not fl.use_pallas_ota:
        return LayoutChoice("perleaf", fl.ota_sections, fl.min_section_rows,
                            fl.max_section_rows)
    return LayoutChoice("sectioned" if fl.ota_sectioned else "slab",
                        fl.ota_sections, fl.min_section_rows,
                        fl.max_section_rows)


def apply_layout(fl: FLConfig, choice: LayoutChoice) -> FLConfig:
    """``fl`` with ``choice`` written into its static layout fields;
    raises LayoutUnavailableError for a choice the gates cannot run."""
    _check_available(choice)
    return dataclasses.replace(
        fl, use_pallas_ota=(choice.engine != "perleaf"),
        ota_sectioned=(choice.engine == "sectioned"),
        ota_sections=choice.sections,
        min_section_rows=int(choice.min_section_rows),
        max_section_rows=int(choice.max_section_rows))


def packer_for_layout(template, choice: LayoutChoice, tail: str = "final"):
    """The (cached) TreePacker a slab or sectioned choice denotes."""
    if choice.engine == "perleaf":
        raise ValueError(f"layout {choice.describe()} uses the per-leaf "
                         f"engine: it has no packer")
    return packer_for(template, tail=tail, sections=choice.sections,
                      min_section_rows=choice.min_section_rows,
                      max_section_rows=choice.max_section_rows)


# ---------------------------------------------------------------------------
# memory model
# ---------------------------------------------------------------------------

def np_size(leaf) -> int:
    """Element count of a tensor or shape-tuple leaf."""
    if isinstance(leaf, torch.Tensor):
        return int(leaf.numel())
    n = 1
    for d in leaf:
        n *= int(d)
    return n


def _per_row_bytes(n_clusters: int, n_clients: int) -> int:
    return 4 * LANE * (int(n_clusters) * (int(n_clients) + 1) + 2)


def estimate_peak_slab_bytes(template, choice: LayoutChoice,
                             n_clusters: int, n_clients: int) -> int:
    """The reference's coarse model of the aggregation's peak float32
    working set: LANE-padded rows x (C·N gradient blocks + C gain streams
    + one noise stream + one estimate). Rows are the whole slab for the
    slab engine, the largest section for the sectioned engine and the
    largest leaf for the per-leaf engine. It ranks candidates; it is not
    an allocator."""
    if choice.engine == "perleaf":
        rows = max((-(-np_size(leaf) // LANE)
                    for _, leaf in tree_flatten_with_path(template)),
                   default=0)
    else:
        packer = packer_for_layout(template, choice)
        rows = (packer.peak_section_rows() if choice.engine == "sectioned"
                else packer.n_rows)
    return rows * _per_row_bytes(n_clusters, n_clients)


def _budget_section_rows(n_clusters: int, n_clients: int,
                         memory_budget_bytes: int) -> int:
    """Largest max_section_rows whose estimated working set fits."""
    return max(1, int(memory_budget_bytes)
               // _per_row_bytes(n_clusters, n_clients))


# ---------------------------------------------------------------------------
# the calibration bench
# ---------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, iters: int, device: torch.device) -> float:
    """Seconds per call: one warm-up call, then ``iters`` calls between
    two device synchronizations on the host clock."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters


def _shape_template(template):
    """The template with every leaf reduced to its shape tuple."""
    return tree_map(lambda l: tuple(int(d) for d in (
        l.shape if isinstance(l, torch.Tensor) else l)), template)


def calibrate_layout(template, n_clusters: int, n_clients: int,
                     thresholds: Tuple[int, ...] = DEFAULT_THRESHOLDS,
                     iters: int = 3, include_perleaf: bool = True,
                     memory_budget_bytes: Optional[int] = None,
                     device="cuda",
                     ) -> Tuple[LayoutChoice, List[Dict[str, Any]]]:
    """Time every candidate layout on ``template`` (a tree of tensors or
    shape tuples) and return (winner, report). Every candidate runs the
    same math on the same synthetic raw (C, N, ...) gradients, drawn with
    the reference's probe keys. With ``memory_budget_bytes``, candidates
    over it are reported with ``us=None`` and a sectioned candidate sized
    to the budget is added; LayoutBudgetError if nothing fits. Report
    entries: {"layout", "us", "peak_bytes", "choice"}."""
    from repro_torch.core import ota
    from repro_torch.core.channel import channel_params

    dev = resolve_device(device)
    template = _shape_template(template)
    # autotuner probes time synthetic traffic; never a training stream
    # repro-lint: allow(bare-prng-seed, fixed synthetic probe seed)
    key = rng.PRNGKey(0)
    paths_leaves = tree_flatten_with_path(template)
    g = tree_unflatten(template, [
        rng.normal(rng.fold_in(key, i), (n_clusters, n_clients) + shape,
                   device=dev)
        for i, (_, shape) in enumerate(paths_leaves)])
    p = rng.uniform(rng.fold_in(key, ota.TUNE_PROBE_FOLD),
                    (n_clusters, n_clients), 0.5, 1.5, device=dev)
    chan = channel_params(FLConfig(
        n_clusters=n_clusters, n_clients=n_clients,
        sigma2=tuple(0.25 + 0.25 * i for i in range(n_clusters))),
        device=dev)

    candidates: List[LayoutChoice] = [
        LayoutChoice("slab", "toplevel", t) for t in dict.fromkeys(thresholds)
    ] + [LayoutChoice("slab", "tail", 0)] + [
        LayoutChoice("sectioned", "toplevel", t)
        for t in dict.fromkeys(thresholds)
    ]
    if memory_budget_bytes is not None:
        rows = _budget_section_rows(n_clusters, n_clients,
                                    memory_budget_bytes)
        candidates.append(LayoutChoice("sectioned", "toplevel", 0, rows))
    if include_perleaf:
        candidates.append(LayoutChoice("perleaf", "toplevel", 0))

    report: List[Dict[str, Any]] = []
    best: Optional[Tuple[float, LayoutChoice]] = None
    for choice in dict.fromkeys(candidates):
        peak = estimate_peak_slab_bytes(template, choice, n_clusters,
                                        n_clients)
        if memory_budget_bytes is not None and peak > memory_budget_bytes:
            report.append({"layout": choice.describe(), "us": None,
                           "peak_bytes": peak, "choice": choice})
            continue
        if choice.engine == "perleaf":
            def fn():
                weighted = tree_map(
                    lambda l: torch.einsum("cn,cn...->c...", p, l), g)
                return ota.ota_aggregate_tree(key, weighted, chan, n_clients)
        else:
            agg = (ota.ota_aggregate_sectioned if choice.engine == "sectioned"
                   else ota.ota_aggregate_client_folded)
            packer = packer_for_layout(template, choice)

            def fn(agg=agg, packer=packer):
                return agg(key, g, p, chan, n_clients, packer)
        us = _time(fn, iters, dev) * 1e6
        report.append({"layout": choice.describe(), "us": us,
                       "peak_bytes": peak, "choice": choice})
        if best is None or us < best[0]:
            best = (us, choice)
    if best is None:
        smallest = min(report, key=lambda r: r["peak_bytes"])
        raise LayoutBudgetError(
            f"memory_budget_bytes={memory_budget_bytes} excludes every "
            f"candidate layout; the smallest is {smallest['layout']} at "
            f"{smallest['peak_bytes']} estimated peak bytes (floor: the "
            f"largest single leaf). Loosen the budget.")
    return best[1], report


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

_TUNE_CACHE: Dict[Any, LayoutChoice] = {}


def _device_desc(device: torch.device) -> str:
    if device.type == "cuda":
        return "cuda:" + torch.cuda.get_device_name(device)
    return device.type


def template_hash(template, n_clusters: int, n_clients: int,
                  thresholds: Tuple[int, ...] = DEFAULT_THRESHOLDS,
                  include_perleaf: bool = True,
                  memory_budget_bytes: Optional[int] = None,
                  device="cpu") -> str:
    """Stable digest of everything a calibration depends on: the
    template's leaf paths, shapes and dtypes, the (C, N) topology, the
    candidate set and the device it was timed on."""
    dev = torch.device(device)
    leaves = tuple(
        ("/".join(path), tuple(int(d) for d in (
            leaf.shape if isinstance(leaf, torch.Tensor) else leaf)),
         str(leaf.dtype) if isinstance(leaf, torch.Tensor)
         else str(torch.float32))
        for path, leaf in tree_flatten_with_path(template))
    desc = repr((leaves, int(n_clusters), int(n_clients), tuple(thresholds),
                 bool(include_perleaf),
                 None if memory_budget_bytes is None
                 else int(memory_budget_bytes), _device_desc(dev)))
    return hashlib.sha256(desc.encode()).hexdigest()[:16]


def _load_disk_cache(path: str) -> Dict[str, Any]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _store_disk_cache(path: str, entries: Dict[str, Any]) -> None:
    """Atomic read-merge-write (temporary file and rename), so concurrent
    tuners never tear the file; persistence is best effort."""
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        merged = dict(_load_disk_cache(path), **entries)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   prefix=".layout_tune.")
        with os.fdopen(fd, "w") as f:
            json.dump(merged, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass


def tune_layout(template, n_clusters: int, n_clients: int,
                thresholds: Tuple[int, ...] = DEFAULT_THRESHOLDS,
                iters: int = 3, include_perleaf: bool = True,
                cache_path: Optional[str] = None,
                memory_budget_bytes: Optional[int] = None,
                device="cuda") -> LayoutChoice:
    """The fastest LayoutChoice for ``template`` at (C, N) on ``device``,
    from the memory cache, the disk cache (``cache_path``, default
    ``$REPRO_TORCH_LAYOUT_CACHE`` or ``DEFAULT_CACHE_PATH``; "" disables
    it) or a fresh ``calibrate_layout``. A disk entry the gates cannot
    run is measured again."""
    dev = resolve_device(device)
    h = template_hash(template, n_clusters, n_clients, thresholds,
                      include_perleaf, memory_budget_bytes, dev)
    choice = _TUNE_CACHE.get(h)
    if choice is not None:
        return choice
    if cache_path is None:
        cache_path = os.environ.get(CACHE_ENV, DEFAULT_CACHE_PATH)
    if cache_path:
        entry = _load_disk_cache(cache_path).get(h)
        if entry is not None:
            try:
                choice = LayoutChoice.from_metadata(entry)
            except (KeyError, TypeError, ValueError):
                choice = None      # stale or foreign entry: measure again
        if choice is not None:
            _TUNE_CACHE[h] = choice
            return choice
    choice, _ = calibrate_layout(template, n_clusters, n_clients,
                                 thresholds=thresholds, iters=iters,
                                 include_perleaf=include_perleaf,
                                 memory_budget_bytes=memory_budget_bytes,
                                 device=dev)
    _TUNE_CACHE[h] = choice
    if cache_path:
        _store_disk_cache(cache_path, {h: choice.to_metadata()})
    return choice


def tuned_fl(fl: FLConfig, template, iters: int = 3,
             include_perleaf: Optional[bool] = None,
             cache_path: Optional[str] = None,
             memory_budget_bytes: Optional[int] = None,
             device="cuda") -> FLConfig:
    """``fl`` with the tuned layout for ``template`` written into its
    static fields. ``include_perleaf`` defaults to ``not fl.faults``, as
    in the reference (faults run only on the slab engines)."""
    if include_perleaf is None:
        include_perleaf = not fl.faults
    choice = tune_layout(template, fl.n_clusters, fl.n_clients, iters=iters,
                         include_perleaf=include_perleaf,
                         cache_path=cache_path,
                         memory_budget_bytes=memory_budget_bytes,
                         device=device)
    return apply_layout(fl, choice)
