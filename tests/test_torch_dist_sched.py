"""The port's per-leaf distributed oracle and sectioned schedule on 4 CPU
gloo ranks (2 clusters × 2 clients) against the JAX package's
``make_hota_train_step`` on 4 forced host devices.

As in ``tests/test_torch_dist.py``: the JAX side runs in a subprocess
(this file, run as a program, with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``) and writes numpy
outputs; the port runs in 4 spawned ranks (``launch.mesh.run_ranks``);
both start from one numpy initial state (``convert.hota_state_from_numpy``
cuts each rank's shards) and see the same batch and keys; the port's
threefry mode is the JAX default (partitionable). The two run at once.

Cases and tolerances:
- the per-leaf step (``use_pallas_ota=False``) in ``ota_mode`` "scatter"
  and "naive", 3 steps with the channel on (σ² = (0.5, 2), H_th = 0.032,
  AWGN 0.3, FedGradNorm, τ_h = 1) against the reference's: metrics, p
  and the FedGradNorm state within rtol 1e-4, ω and the tree Adam's
  first moment within relative L2 1e-3 (the gains and the AWGN are
  ``rng.normal``, within erfinv's last place of ``jax.random.normal``; a
  first Adam step moves an entry with |ĝ| at float noise by ±lr either
  way, ``test_torch_sim.py``'s rule), every gain and AWGN word drawn
  through the stream dispatcher (``ops.bits``: the card's kernel there,
  the counted plain draw here);
- the sectioned backward (``sectioned=True``) bit for bit against the
  full-slab backward on shared keys, in count modes {psum, local} ×
  ``max_section_rows`` {0, 8} (the reference's
  ``tests/dist_programs/dist_sectioned.py`` pin 1);
- the sectioned step (``ota_sectioned=True``, ``max_section_rows=8``)
  over 2 rounds in both count modes: bit for bit against the port's
  full-slab step on the same split layout, and within the tolerances of
  ``test_torch_dist.py`` (rtol 1e-4, ω relative L2 1e-4) against the
  reference's sectioned step (``dist_sectioned.py`` pin 3);
- the configurations these schedules lifted from the refusals now build,
  and the reference's own refusals stay (``test_torch_dist.py``).
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.convert import hota_state_from_numpy
from repro_torch.core.channel import channel_params
from repro_torch.core.hota import (
    OTACtx, build_axes_registry, full_transmission_mask, make_ota_gather,
    region_mask_key,
)
from repro_torch.core.hota_slab import (
    make_packed_omega_gather, packed_omega_key,
)
from repro_torch.core.hota_step import (
    make_hota_step_parts, make_hota_train_step,
)
from repro_torch.kernels.ota_channel import ref as kref
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.model import build_model
from repro_torch.models.params import abstract_params, logical_axes
from repro_torch.sharding.mesh_utils import Mesh
# one_torch_thread: an autouse fixture
from torch_threads import JAX_XLA_FLAGS, one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))

C, N, B, MAXC = 2, 2, 4, 8
DIMS = (32, 64, 128, 1152, 64, 32)
STEPS = 3
SEC_STEPS = 2
LR = 1e-3
FL_CHANNEL = dict(n_clusters=C, n_clients=N, sigma2=(0.5, 2.0),
                  noise_std=0.3, tau_h=1)
OTA_MODES = ("scatter", "naive")
COUNT_MODES = ("psum", "local")
SPLIT_ROWS = 8
FL_SECTIONED = dict(FL_CHANNEL, ota_sectioned=True,
                    max_section_rows=SPLIT_ROWS)


def _model():
    return build_model(ModelConfig(family="mlp", compute_dtype="float32"),
                       DIMS)


def _omega_specs(model):
    return {"final": model.final_specs(), "trunk": model.trunk_specs()}


def _inputs():
    """The shared numpy ω, head, batch and keys."""
    r = np.random.default_rng(1)
    model = _model()

    def draw(specs):
        return tree_unflatten(specs, [
            (r.standard_normal(s.shape) / np.sqrt(s.shape[0])
             ).astype(np.float32) for s in tree_leaves(specs)])
    omega = draw(_omega_specs(model))
    head = draw(model.head_specs(MAXC))
    x = r.standard_normal((C, N, B, DIMS[0])).astype(np.float32)
    y = r.integers(0, MAXC, (C, N, B)).astype(np.int32)
    return {"omega": omega, "head": head, "x": x, "y": y,
            "keys": [np.asarray([0, 17 + s], np.uint32)
                     for s in range(STEPS)]}


def _state0(inp, per_leaf: bool):
    """The reference step's init (numpy, global) with the shared ω and
    heads: the tree Adam on the per-leaf oracle, else the slab Adam."""
    model = _model()
    zeros = lambda t: tree_map(lambda l: np.zeros(l.shape, np.float32),  # noqa
                               t)
    if per_leaf:
        opt = (np.int32(0), zeros(inp["omega"]), zeros(inp["omega"]))
    else:
        slab = C * N * sum(
            int(np.prod(l.shape)) // (C * N if "embed" in a else 1)
            for l, a in zip(tree_leaves(inp["omega"]), tree_leaves(
                logical_axes(_omega_specs(model)))))
        opt = (np.int32(0), np.zeros(slab, np.float32),
               np.zeros(slab, np.float32))
    heads = tree_map(lambda h: np.broadcast_to(h, (C * N,) + h.shape).copy(),
                     inp["head"])
    return (inp["omega"], opt, heads,
            (np.int32(0), zeros(heads), zeros(heads)),
            np.ones(C * N, np.float32), np.zeros(C * N, np.float32),
            np.zeros(C * N, np.float32), np.int32(0),
            np.ones(C * N, np.float32), np.int32(0))


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    return None if x is None else np.asarray(x)


# --------------------------------------------------------------------------
# the JAX side (run as a program: 4 forced host devices)
# --------------------------------------------------------------------------

def _jax_main(out_path):
    os.environ["XLA_FLAGS"] = JAX_XLA_FLAGS
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    import repro.core.hota_step as hs
    import repro.models.model as rmodel
    from repro.common.config import FLConfig as JFL
    from repro.common.config import ModelConfig as JMC
    from repro.common.config import TrainConfig as JTC

    rmodel.PAPER_MLP_DIMS = DIMS
    model = rmodel.build_model(JMC(family="mlp", compute_dtype="float32"))
    mesh = JMesh(np.array(jax.devices()).reshape(C, N), ("cluster", "client"))
    inp = _inputs()
    orig = hs.make_packed_omega_gather
    runs = [(f"leaf_{m}", dict(FL_CHANNEL, use_pallas_ota=False, ota_mode=m),
             STEPS, "psum") for m in OTA_MODES]
    runs.append(("sectioned", FL_SECTIONED, SEC_STEPS, "psum"))
    out = {}
    for tag, fl_kw, steps, count_mode in runs:
        hs.make_packed_omega_gather = partial(orig, count_mode=count_mode)
        init_fn, step_fn, specs, bspec = hs.make_hota_train_step(
            model, mesh, JFL(**fl_kw), JTC(lr=LR), loss_kind="cls",
            n_out=MAXC)
        st = init_fn(jax.random.PRNGKey(123))
        st = st._replace(omega=jax.tree.map(jnp.asarray, inp["omega"]),
                         heads=jax.tree.map(
                             lambda h: jnp.broadcast_to(h, (C * N,) + h.shape),
                             inp["head"]))
        out[tag + "_state0"] = _plain(jax.tree.map(np.asarray, st))
        st = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(
            mesh, s)), st, specs, is_leaf=lambda z: isinstance(z, P))
        xb = jax.device_put(inp["x"].reshape(C * N * B, -1),
                            NamedSharding(mesh, bspec[0]))
        yb = jax.device_put(inp["y"].reshape(C * N * B),
                            NamedSharding(mesh, bspec[1]))
        step = jax.jit(step_fn)
        metrics = []
        for s in range(steps):
            st, m = step(st, xb, yb, jnp.asarray(inp["keys"][s]))
            metrics.append({k: float(v) for k, v in m.items()})
        out[tag] = {"metrics": metrics,
                    "state": _plain(jax.tree.map(np.asarray, st))}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# --------------------------------------------------------------------------
# the port side (4 gloo ranks)
# --------------------------------------------------------------------------

def _steps(mesh, model, fl_kw, inp, per_leaf, steps, count_mode=None):
    _, step_fn, specs, _ = make_hota_train_step(
        model, mesh, FLConfig(**fl_kw), TrainConfig(lr=LR), loss_kind="cls",
        n_out=MAXC, count_mode=count_mode)
    st = hota_state_from_numpy(_state0(inp, per_leaf), mesh, mesh.rank,
                               "cpu", specs)
    cidx, cli = mesh.coords["cluster"], mesh.coords["client"]
    metrics = []
    for s in range(steps):
        st, m = step_fn(st, inp["x"][cidx, cli], inp["y"][cidx, cli],
                        inp["keys"][s])
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "state": st}


def _slab_backward(mesh, model, g_full, p_dev, count_mode, rows, sectioned):
    """One rank's slab backward on its (cluster, client) cotangents."""
    cidx, cli = mesh.coords["cluster"], mesh.coords["client"]
    specs = _omega_specs(model)
    template = abstract_params(specs)
    axes = tree_leaves(logical_axes(specs))
    gather, _ = make_packed_omega_gather(
        mesh, ("client", "cluster"), ("cluster",), N, C * N, torch.float32,
        template, axes, n_clusters=C, count_mode=count_mode,
        max_section_rows=rows, sectioned=sectioned)
    chan = channel_params(FLConfig(**FL_CHANNEL), n_clusters=C)
    ctx = OTACtx(p_weight=torch.tensor(p_dev[cidx, cli]),
                 key=packed_omega_key(rng.PRNGKey(42)), sigma2=chan.sigma2,
                 h_th=chan.h_threshold, noise_std=chan.noise_std,
                 ota_on=chan.ota_on)
    shard = tree_unflatten(template, [
        torch.zeros([s // (C * N) if d == a.index("embed") else s
                     for d, s in enumerate(l.shape)] if "embed" in a
                    else list(l.shape), requires_grad=True)
        for l, a in zip(tree_leaves(template), axes)])
    full = gather(shard, ctx)
    torch.autograd.backward(tree_leaves(full), [
        torch.from_numpy(g[cidx, cli]) for g in tree_leaves(g_full)])
    return [l.grad.clone() for l in tree_leaves(shard)]


def _rank(mesh, inp, g_full, p_dev):
    torch.set_num_threads(1)
    rng.set_threefry_partitionable(True)
    model = _model()
    out = {}
    for mode in OTA_MODES:
        kref.plain_draw_counter.reset()
        out[f"leaf_{mode}"] = _steps(
            mesh, model, dict(FL_CHANNEL, use_pallas_ota=False,
                              ota_mode=mode), inp, True, STEPS)
        out[f"leaf_{mode}"]["plain_draws"] = kref.plain_draw_counter.count
    for cm in COUNT_MODES:
        out[("sectioned", cm)] = _steps(mesh, model, FL_SECTIONED, inp,
                                        False, SEC_STEPS, count_mode=cm)
        out[("split", cm)] = _steps(
            mesh, model, dict(FL_CHANNEL, max_section_rows=SPLIT_ROWS), inp,
            False, SEC_STEPS, count_mode=cm)
    out["bwd"] = {}
    for cm in COUNT_MODES:
        for rows in (0, SPLIT_ROWS):
            out["bwd"][(cm, rows)] = [
                _slab_backward(mesh, model, g_full, p_dev, cm, rows, sec)
                for sec in (False, True)]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides, once for the module: (reference results, port ranks'
    results, the inputs)."""
    tmp = tmp_path_factory.mktemp("dist_sched")
    ref_path = tmp / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             str(ref_path)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    inp = _inputs()
    r = np.random.default_rng(6)
    g_full = tree_map(lambda l: r.standard_normal(
        (C, N) + tuple(l.shape)).astype(np.float32),
        abstract_params(_omega_specs(_model())))
    p_dev = r.uniform(0.5, 1.5, (C, N)).astype(np.float32)
    try:
        ranks = run_ranks(_rank, (inp, g_full, p_dev), device="cpu")
    finally:
        log, _ = proc.communicate(timeout=400)
    assert proc.returncode == 0, log[-4000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    return ref, ranks, inp


def _mesh(rank):
    return Mesh((C, N), ("cluster", "client"), rank=rank)


def _rel_l2(a, b):
    a = np.concatenate([np.ravel(x) for x in a])
    b = np.concatenate([np.ravel(x) for x in b])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _specs(fl_kw, count_mode=None):
    return make_hota_step_parts(
        _model(), _mesh(0), FLConfig(**fl_kw), TrainConfig(lr=LR),
        loss_kind="cls", n_out=MAXC, count_mode=count_mode).state_specs


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, tuple):
        return [v for e in x for v in _leaves(e)]
    return [] if x is None else [np.asarray(x)]


def _match_reference(got_runs, want, fl_kw, steps, w_tol, count_mode=None):
    """Metrics, p and the FedGradNorm state within rtol 1e-4; ω and the
    optimizer's first moment within relative L2 ``w_tol``."""
    specs = _specs(fl_kw, count_mode)
    got_w, want_w = [], []
    for r, res in enumerate(got_runs):
        for s in range(steps):
            assert set(res["metrics"][s]) == set(want["metrics"][s])
            for k, v in want["metrics"][s].items():
                np.testing.assert_allclose(res["metrics"][s][k], v,
                                           rtol=1e-4, atol=1e-7,
                                           err_msg=f"rank {r} step {s} {k}")
        st = res["state"]
        w = hota_state_from_numpy(want["state"], _mesh(r), r, "cpu", specs)
        for f in ("p", "fgn_mu", "fgn_nu", "f0"):
            np.testing.assert_allclose(getattr(st, f).numpy(),
                                       getattr(w, f).numpy(), rtol=1e-4,
                                       atol=1e-7, err_msg=f"rank {r} {f}")
        assert int(st.step) == int(w.step) == steps
        assert int(st.opt.step) == int(w.opt.step) == steps
        got_w += [l.numpy() for l in tree_leaves(st.omega)
                  + tree_leaves(st.opt.mu)]
        want_w += [l.numpy() for l in tree_leaves(w.omega)
                   + tree_leaves(w.opt.mu)]
    assert _rel_l2(got_w, want_w) < w_tol


def test_per_leaf_initial_state_is_the_reference_init(runs):
    """The per-leaf runs start from the reference step's own init: the
    tree Adam's zero moments shaped like ω."""
    ref, _, inp = runs
    for mode in OTA_MODES:
        got, want = _leaves(_state0(inp, True)), _leaves(
            ref[f"leaf_{mode}_state0"])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", OTA_MODES)
def test_per_leaf_step_matches_jax(runs, mode):
    ref, ranks, _ = runs
    _match_reference([res[f"leaf_{mode}"] for res in ranks],
                     ref[f"leaf_{mode}"],
                     dict(FL_CHANNEL, use_pallas_ota=False, ota_mode=mode),
                     STEPS, 1e-3)


def test_per_leaf_draws_go_through_the_stream_dispatcher(runs):
    """The per-leaf gains and AWGN come from ``ops.bits`` (on the host the
    plain draw, counted: on the card the same calls launch the stream
    kernel)."""
    _, ranks, _ = runs
    for res in ranks:
        for mode in OTA_MODES:
            assert res[f"leaf_{mode}"]["plain_draws"] > 0


def test_per_leaf_modes_differ_only_in_the_channel_draw(runs):
    """Scatter and naive draw different masks (per region against whole
    tensor), so their steps differ, while both stay finite and train."""
    _, ranks, _ = runs
    a = ranks[0]["leaf_scatter"]["metrics"]
    b = ranks[0]["leaf_naive"]["metrics"]
    assert a[0]["loss"] == b[0]["loss"]     # step 0's loss is pre-update
    assert a[-1] != b[-1]
    for m in a + b:
        assert all(np.isfinite(v) for v in m.values())


@pytest.mark.parametrize("rows", [0, SPLIT_ROWS])
@pytest.mark.parametrize("count_mode", COUNT_MODES)
def test_sectioned_backward_is_the_full_slab_backward(runs, count_mode,
                                                      rows):
    _, ranks, _ = runs
    for r, res in enumerate(ranks):
        full, sec = res["bwd"][(count_mode, rows)]
        for a, b in zip(full, sec):
            assert torch.equal(a, b), f"rank {r}"
        assert any(bool(a.abs().sum() > 0) for a in full)


@pytest.mark.parametrize("count_mode", COUNT_MODES)
def test_sectioned_step_is_the_full_slab_step(runs, count_mode):
    """On the same split layout the sectioned schedule changes no value
    of the step: metrics and every state leaf bit for bit."""
    from repro_torch.common.tree import state_map
    _, ranks, _ = runs
    for r, res in enumerate(ranks):
        a, b = res[("sectioned", count_mode)], res[("split", count_mode)]
        assert a["metrics"] == b["metrics"], f"rank {r}"
        pairs = []
        state_map(lambda u, v: pairs.append((u, v)), a["state"], b["state"])
        assert pairs and all(torch.equal(u, v) for u, v in pairs)


@pytest.mark.parametrize("count_mode", COUNT_MODES)
def test_sectioned_step_matches_jax(runs, count_mode):
    ref, ranks, _ = runs
    _match_reference([res[("sectioned", count_mode)] for res in ranks],
                     ref["sectioned"], FL_SECTIONED, SEC_STEPS, 1e-4,
                     count_mode=count_mode)


def test_per_leaf_region_masks_tile_the_leaf():
    """Scatter mode's full mask is its client regions' masks side by
    side, each drawn under ``region_mask_key`` (what phase B reads and
    the backward applies)."""
    key, dev = rng.PRNGKey(8), torch.device("cpu")
    args = (torch.tensor(0.5), torch.tensor(0.032), torch.tensor(1.0), 1)
    full = full_transmission_mask(key, (6, 4), 0, 2, *args, True, dev)
    from repro_torch.core.hota import channel_mask_for
    for r in range(2):
        want = channel_mask_for(region_mask_key(key, r), (3, 4), *args, dev)
        assert torch.equal(full[3 * r:3 * r + 3], want)
    whole = full_transmission_mask(key, (6, 4), 0, 2, *args, False, dev)
    assert torch.equal(whole, channel_mask_for(key, (6, 4), *args, dev))
    assert not torch.equal(whole, full)


def test_axes_registry_and_gather_refusals():
    model = _model()
    reg = build_axes_registry(model)
    assert len(reg["layers"]) == 2 * (len(DIMS) - 2)
    assert reg["final"] == [("mlp",), ("embed", "mlp")]
    with pytest.raises(ValueError, match="ota_mode"):
        make_ota_gather(_mesh(0), ("client", "cluster"), ("cluster",), N,
                        C * N, torch.float32, mode="tree")
    # the dense trunk takes the hook now: its registry is the
    # reference's, and the hook sees the embedding, then each layer
    # tagged as the reference tags it, without changing the output
    from repro.core.hota import build_axes_registry as jax_registry
    from repro.models.model import build_model as jax_build_model
    from repro_torch import configs
    from repro_torch.models.params import init_params
    for arch, tags in (("stablelm_3b", [(0,), (1,)]),
                       ("gemma3_12b", [(0, 0), (0, 1), (0, 2), (1, 0),
                                       (1, 1), (1, 2)])):
        cfg = configs.get_smoke_config(arch)
        dense = build_model(cfg)
        reg = build_axes_registry(dense)
        assert reg == jax_registry(jax_build_model(cfg))
        assert [tuple(a) for a in reg["embed"]] == [("vocab", "embed")]
        params = init_params(dense.trunk_specs(), rng.PRNGKey(1))
        seen = []

        def hook(lp, klass, *t):
            seen.append((klass, t, len(tree_leaves(lp))))
            return lp
        tok = torch.arange(8).reshape(1, 8)
        got = dense.trunk_apply(params, tok, param_hook=hook)[0]
        assert seen == [("embed", (), 1)] + [
            ("layers", t, len(reg["layers"])) for t in tags]
        assert torch.equal(got, dense.trunk_apply(params, tok)[0])


@pytest.mark.parametrize("fl_kw", [
    dict(use_pallas_ota=False), dict(use_pallas_ota=False, ota_mode="naive"),
    dict(ota_sectioned=True), dict(max_section_rows=64),
    dict(ota_sectioned=True, max_section_rows=64)],
    ids=["per_leaf", "per_leaf_naive", "sectioned", "max_section_rows",
         "sectioned_split"])
def test_lifted_configurations_build(fl_kw):
    parts = make_hota_step_parts(_model(), _mesh(0),
                                 FLConfig(n_clusters=C, n_clients=N, **fl_kw),
                                 TrainConfig(lr=LR), loss_kind="cls",
                                 n_out=MAXC)
    assert parts.state_specs.opt.mu is not None


if __name__ == "__main__":
    _jax_main(sys.argv[1])
