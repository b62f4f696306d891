"""The port's section-layout autotuner against the JAX package's.

``LayoutChoice`` metadata must read in either package (checkpoint
manifests), the availability rules and the memory model must equal the
reference's, the calibration must report the reference's candidates, the
port's disk cache must round trip in its own file, and ``run_sweep`` must
tune by default on the CPU at narrow width. Timings here are the CPU's
and only rank candidates within one call; no number is compared across
packages.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.common.layout_tune as jlt
from repro.common.config import (
    FLConfig as JFLConfig, ModelConfig as JModelConfig,
)
from repro.data import radcom as jradcom
from repro.models.model import Model as JModel
from repro_torch.common import layout_tune as lt
from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
from repro_torch.common.tree import tree_map
from repro_torch.core.sim import HotaSim
from repro_torch.data.federated import FederatedBatcher
from repro_torch.experiments import paper_common
from repro_torch.models.model import build_model

C, N = 3, 2
DIMS = (32, 64, 128, 64, 32, 16)
N_CLS = [jradcom.N_CLASSES[jradcom.TASKS[i]] for i in range(N)]


@pytest.fixture(autouse=True)
def _hermetic(monkeypatch, tmp_path):
    """One intra-op thread; the port's layout cache in tmp_path and both
    packages' in-memory caches empty."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv(lt.CACHE_ENV, str(tmp_path / "layout_tune.json"))
    lt._TUNE_CACHE.clear()
    yield
    lt._TUNE_CACHE.clear()
    torch.set_num_threads(prev)


def _tiny(groups=6):
    """Small top-level trunk groups (the reference test's template has
    six), as shape tuples for the port and ShapeDtypeStructs for JAX."""
    shapes = {"final": {"w": (40, 8), "b": (8,)},
              "trunk": {f"fc{i}": {"w": (10 + i, 9), "b": (9,)}
                        for i in range(groups)}}
    return shapes, jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s, jnp.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))


def _paper():
    m = JModel(JModelConfig(family="mlp"))
    jt = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32),
                      {"final": m.final_specs(), "trunk": m.trunk_specs()},
                      is_leaf=lambda s: hasattr(s, "axes"))
    port = build_model(ModelConfig(family="mlp"))
    return tree_map(lambda s: s.shape, {"final": port.final_specs(),
                                        "trunk": port.trunk_specs()}), jt


CHOICES = [("slab", "toplevel", 0, 0), ("slab", "toplevel", 256, 0),
           ("slab", "tail", 0, 0), ("sectioned", "toplevel", 64, 0),
           ("sectioned", "toplevel", 0, 177), ("perleaf", "toplevel", 0, 0)]


@pytest.mark.parametrize("fields", CHOICES, ids=lambda f: "-".join(map(str, f)))
def test_metadata_round_trips_across_packages(fields):
    mine, theirs = lt.LayoutChoice(*fields), jlt.LayoutChoice(*fields)
    assert mine.to_metadata() == theirs.to_metadata()
    assert mine.describe() == theirs.describe()
    assert tuple(jlt.LayoutChoice.from_metadata(
        json.loads(json.dumps(mine.to_metadata())))) == fields
    assert tuple(lt.LayoutChoice.from_metadata(
        json.loads(json.dumps(theirs.to_metadata())))) == fields
    # apply_layout writes the same FLConfig fields in both packages
    fl = lt.apply_layout(FLConfig(n_clusters=C, n_clients=N), mine)
    jfl = jlt.apply_layout(JFLConfig(n_clusters=C, n_clients=N), theirs)
    for name in ("use_pallas_ota", "ota_sectioned", "ota_sections",
                 "min_section_rows", "max_section_rows"):
        assert getattr(fl, name) == getattr(jfl, name)
    assert lt.layout_of(fl) == mine


BAD = [("warp-drive", "toplevel", 0, 0), ("sectioned", "tail", 0, 0),
       ("perleaf", "toplevel", 64, 0), ("perleaf", "toplevel", 0, 8),
       ("slab", "toplevel", 0, -1), ("slab", "toplevel", 256, 64)]


@pytest.mark.parametrize("fields", BAD, ids=lambda f: "-".join(map(str, f)))
def test_refuses_what_the_reference_refuses(fields):
    with pytest.raises(jlt.LayoutUnavailableError):
        jlt.apply_layout(JFLConfig(), jlt.LayoutChoice(*fields))
    with pytest.raises(lt.LayoutUnavailableError):
        lt.apply_layout(FLConfig(), lt.LayoutChoice(*fields))
    md = dict(zip(("engine", "sections", "min_section_rows",
                   "max_section_rows"), fields))
    with pytest.raises(lt.LayoutUnavailableError):
        lt.LayoutChoice.from_metadata(md)
    with pytest.raises(ValueError, match="per-leaf"):
        lt.packer_for_layout(_tiny()[0], lt.LayoutChoice("perleaf",
                                                         "toplevel", 0))


@pytest.mark.parametrize("which", ["tiny", "paper"])
def test_peak_bytes_equal_the_reference(which):
    tpl, jtpl = _tiny() if which == "tiny" else _paper()
    for fields in CHOICES + [("sectioned", "toplevel", 1024, 0)]:
        assert lt.estimate_peak_slab_bytes(
            tpl, lt.LayoutChoice(*fields), 10, 3) == \
            jlt.estimate_peak_slab_bytes(jtpl, jlt.LayoutChoice(*fields), 10,
                                         3), fields


def test_calibrate_reports_the_reference_candidates(monkeypatch):
    """The same candidates, in the same order, with the same estimated
    peak bytes. The reference's candidates are listed without being timed
    (its timer is stubbed: compiling ten jitted engines would dominate the
    test); the port times its own on the CPU."""
    monkeypatch.setattr(jlt, "_time", lambda fn, *args, iters: 1.0)
    tpl, jtpl = _tiny(groups=2)
    budget = 10 ** 6
    choice, report = lt.calibrate_layout(tpl, C, N, iters=1, device="cpu",
                                         memory_budget_bytes=budget)
    _, jreport = jlt.calibrate_layout(jtpl, C, N, iters=1,
                                      memory_budget_bytes=budget)
    assert [r["layout"] for r in report] == [r["layout"] for r in jreport]
    assert [r["peak_bytes"] for r in report] == [r["peak_bytes"]
                                                 for r in jreport]
    timed = [r for r in report if r["us"] is not None]
    assert min(timed, key=lambda r: r["us"])["choice"] == choice
    assert "perleaf" in {r["layout"] for r in report}
    with pytest.raises(lt.LayoutBudgetError):
        lt.calibrate_layout(tpl, C, N, iters=1, device="cpu",
                            memory_budget_bytes=1)


def test_disk_cache_round_trips(tmp_path):
    """A sentinel written under the template's hash answers a cold tune
    without timing; a corrupt entry is measured again; the hash depends on
    the topology and the device, and the port never writes the JAX
    package's cache file."""
    tpl, _ = _tiny(groups=2)
    path = str(tmp_path / "cache.json")
    h = lt.template_hash(tpl, C, N, device="cpu")
    sentinel = lt.LayoutChoice("slab", "tail", 0)
    lt._store_disk_cache(path, {h: sentinel.to_metadata()})
    assert lt.tune_layout(tpl, C, N, iters=1, cache_path=path,
                          device="cpu") == sentinel
    # the memory cache answers next, without the file
    assert lt.tune_layout(tpl, C, N, iters=1, device="cpu",
                          cache_path=str(tmp_path / "gone.json")) == sentinel
    lt._store_disk_cache(path, {h: {"engine": "warp-drive"}})
    lt._TUNE_CACHE.clear()
    measured = lt.tune_layout(tpl, C, N, iters=1, cache_path=path,
                              device="cpu")
    assert isinstance(measured, lt.LayoutChoice)
    assert json.load(open(path))[h] == measured.to_metadata()
    assert lt.template_hash(tpl, C, N + 1, device="cpu") != h
    assert lt.template_hash(tpl, C, N, device="meta") != h
    assert lt.DEFAULT_CACHE_PATH != jlt.DEFAULT_CACHE_PATH
    assert lt.CACHE_ENV != "REPRO_LAYOUT_CACHE"


def _narrow_setup(fl, batch=24, seed=0, device="cuda"):
    sim = HotaSim(build_model(ModelConfig(family="mlp"), DIMS), fl,
                  TrainConfig(lr=3e-4), N_CLS, device=device)
    data = jradcom.make_radcom_dataset(
        jradcom.RadComConfig(n_points=600, feature_dim=DIMS[0]))
    parts = jradcom.client_partition(data, fl.n_clusters, fl.n_clients,
                                     seed=seed)
    return sim, FederatedBatcher(parts, batch, seed=seed + 1)


def test_run_sweep_tunes_by_default(monkeypatch, tmp_path, capsys):
    """run_sweep tunes the model's template before the sweep and prints the
    layout; the calibration persists, so a second sweep does not time
    again; an explicit engine flag skips the tuner."""
    monkeypatch.setattr(paper_common, "RESULTS_DIR", str(tmp_path / "res"))
    monkeypatch.setattr(paper_common, "paper_mlp_setup", _narrow_setup)
    exps = {"a": dict(sigma2=[0.5, 1.0, 1.0]), "b": dict(weighting="equal")}
    kw = dict(steps=2, n_clusters=C, n_clients=N, batch=4, log_every=1,
              device="cpu", force=True)
    res = paper_common.run_sweep(exps, **kw)
    assert sorted(res) == ["a", "b"]
    assert all(np.isfinite(r["loss_mean_tasks"]).all() for r in res.values())
    out = capsys.readouterr().out
    line = next(l for l in out.splitlines() if "layout:" in l)
    assert "tuned on cpu" in line
    cached = json.load(open(tmp_path / "layout_tune.json"))
    assert len(cached) == 1

    def no_timing(*a, **k):
        raise AssertionError("calibrated again")
    monkeypatch.setattr(lt, "calibrate_layout", no_timing)
    lt._TUNE_CACHE.clear()
    paper_common.run_sweep(exps, **kw)          # from the disk cache
    assert line in capsys.readouterr().out
    paper_common.run_sweep(exps, ota_streaming=True, **kw)
    assert "autotuner skipped" in capsys.readouterr().out


def test_run_sweep_reuses_results_only_for_the_same_settings(monkeypatch,
                                                             tmp_path):
    """A cached result records the sweep's settings, the scenario's
    overrides and the layout it ran on; a sweep with other rounds or
    overrides, or a result without settings, runs again; ``results_dir``
    keeps a run's results out of RESULTS_DIR."""
    monkeypatch.setattr(paper_common, "RESULTS_DIR", str(tmp_path / "res"))
    monkeypatch.setattr(paper_common, "paper_mlp_setup", _narrow_setup)
    exps = {"a": dict(sigma2=[0.5, 1.0, 1.0])}
    kw = dict(n_clusters=C, n_clients=N, batch=4, log_every=1,
              device="cpu", tune=False)
    short = paper_common.run_sweep(exps, steps=2, **kw)["a"]
    assert short["run"]["steps"] == 2 and short["run"]["tune"] is False
    assert short["layout"] == "slab/sections=toplevel/min_section_rows=0"
    assert short["spec"] == {"sigma2": [0.5, 1.0, 1.0]}
    longer = paper_common.run_sweep(exps, steps=3, **kw)["a"]
    assert longer["steps"] == 3 and len(longer["loss_mean_tasks"]) == 3
    other = paper_common.run_sweep({"a": dict(sigma2=[1.0, 1.0, 1.0])},
                                   steps=3, **kw)["a"]
    assert other["sigma2"] == [1.0, 1.0, 1.0]

    def no_run(*a, **k):
        raise AssertionError("ran again")
    monkeypatch.setattr(paper_common, "paper_mlp_setup", no_run)
    assert paper_common.run_sweep({"a": dict(sigma2=[1.0, 1.0, 1.0])},
                                  steps=3, **kw)["a"] == json.loads(
                                      json.dumps(other))
    path = tmp_path / "res" / "a.json"
    old = json.load(open(path))
    del old["run"]
    json.dump(old, open(path, "w"))
    with pytest.raises(AssertionError, match="ran again"):
        paper_common.run_sweep({"a": dict(sigma2=[1.0, 1.0, 1.0])},
                               steps=3, **kw)
    monkeypatch.setattr(paper_common, "paper_mlp_setup", _narrow_setup)
    own = tmp_path / "own"
    paper_common.run_sweep(exps, steps=2, results_dir=str(own), **kw)
    assert (own / "a.json").exists()
    assert json.load(open(path)) == old
