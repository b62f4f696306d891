"""The port's distributed HOTA step on 4 CPU gloo ranks (2 clusters × 2
clients) against the JAX package's ``make_hota_train_step`` on 4 forced
host devices.

The JAX side runs in a subprocess (this file, run as a program) that sets
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` before importing
JAX, as ``tests/test_dist.py`` runs its programs; it writes numpy outputs.
The port side runs in 4 spawned rank processes (``launch.mesh.run_ranks``).
Both start from one numpy initial state (``convert.hota_state_from_numpy``
cuts each rank's shards from it) and the same batch and keys; the port's
threefry mode is set to the JAX default (partitionable). The two run at
once.

Cases and tolerances:
- 3 steps with the channel on (σ² = (0.5, 2), H_th = 0.032, AWGN 0.3,
  FedGradNorm) in both count modes ("local": K6's plain version, "psum":
  K5's), each against the reference's own step in the same count mode:
  metrics, p and the FedGradNorm state within rtol 1e-4 (summation order
  and XLA's fused multiply-adds in the scalar Adam); ω and the slab Adam
  moments within relative L2 1e-4 (a first Adam step moves an entry with
  |ĝ| at float noise by ±lr either way, ROADMAP Queue 3);
- the two count modes bit for bit (a mask is cluster-constant, so
  masking before or after the LAN sum adds the same terms);
- two microbatches against the full batch (rtol 1e-4, ω relative L2
  1e-4: float rounding of the averaged gradient);
- dist ≡ sim: with the channel off and equal weighting, the step against
  the port's ``HotaSim`` over 3 steps (losses within 2e-4; parameters off
  by at most ±2·lr·steps, on under 5 % of entries, the reference's
  ``dist_vs_sim.py`` rule);
- the slab backward on shared keys against ``packed_omega_aggregate_ref``
  in both count modes and both threefry modes (rtol 2e-5, atol 1e-6, the
  reference program's);
- the zero-copy pin: the backward produces no tensor of the packed slab's
  (P,) or (C, P) shape;
- fault injection (``tests/dist_programs/dist_faults.py`` for the port):
  3 faulted steps (dropout 0.3, blackout 0.2, stragglers 0.5, staleness
  2: stragglers in every step, a dropped client, then a dead cluster) in
  both count modes against the reference's faulted step, within the
  tolerances above (the stale copy as ω); zero-rate faults against the
  unfaulted steps bit for bit; total blackout freezes the whole state bit
  for bit (only ``step`` advances);
- the refusals, by name.
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
from repro_torch.core.channel import channel_params, fault_params
from repro_torch.core.hota import OTACtx
from repro_torch.core.hota_slab import (
    make_packed_omega_gather, packed_omega_aggregate_ref, packed_omega_key,
)
from repro_torch.core.hota_step import (
    HotaState, make_hota_step_parts, make_hota_train_step, shard_state,
)
from repro_torch.core.sim import HotaSim
from repro_torch.convert import hota_state_from_numpy
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.model import build_model
from repro_torch.models.params import abstract_params, logical_axes
from repro_torch.optim.adam import AdamState, SlabAdamState
from repro_torch.sharding.mesh_utils import Mesh, shard_slices

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))

C, N, B, MAXC = 2, 2, 4, 8
# Table-I's depth at narrow widths; fc2's weight (128 x 1152) spans two
# stream chunks. Every "embed" dim splits over the 4 shards.
DIMS = (32, 64, 128, 1152, 64, 32)
STEPS = 3
LR = 1e-3
FL_CHANNEL = dict(n_clusters=C, n_clients=N, sigma2=(0.5, 2.0),
                  noise_std=0.3, tau_h=1)
MODES = ("local", "psum")
LIVE = [0.0, 1.0]        # cluster 0 dead in the partial-participation case
FL_FAULTS = dict(FL_CHANNEL, faults=True, dropout_rate=0.3,
                 blackout_rate=0.2, straggler_rate=0.5, staleness_rounds=2)


def _inputs():
    """The shared numpy initial state (global, reference layout), batch
    and keys."""
    r = np.random.default_rng(0)
    model = build_model(ModelConfig(family="mlp", compute_dtype="float32"),
                        DIMS)

    def draw(specs, lead=()):
        return tree_unflatten(specs, [
            (r.standard_normal(lead + s.shape) / np.sqrt(s.shape[0])
             ).astype(np.float32) for s in tree_leaves(specs)])
    omega = {"final": draw(model.final_specs()),
             "trunk": draw(model.trunk_specs())}
    head = draw(model.head_specs(MAXC))
    x = r.standard_normal((C, N, B, DIMS[0])).astype(np.float32)
    y = r.integers(0, MAXC, (C, N, B)).astype(np.int32)
    return {"omega": omega, "head": head, "x": x, "y": y,
            "keys": [np.asarray([0, 7 + s], np.uint32)
                     for s in range(STEPS)]}


def _plain(x):
    """Named tuples to tuples and arrays to numpy, so that the reference's
    state pickles without the JAX package's classes."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    return None if x is None else np.asarray(x)


# --------------------------------------------------------------------------
# the JAX side (run as a program: 4 forced host devices)
# --------------------------------------------------------------------------

def _jax_main(out_path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
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
    out = {}
    for tag, fl_kw in (("", FL_CHANNEL), ("faults_", FL_FAULTS)):
        for mode in MODES:
            hs.make_packed_omega_gather = partial(orig, count_mode=mode)
            init_fn, step_fn, specs, bspec = hs.make_hota_train_step(
                model, mesh, JFL(**fl_kw), JTC(lr=LR), loss_kind="cls",
                n_out=MAXC)
            st = init_fn(jax.random.PRNGKey(123))
            omega = jax.tree.map(jnp.asarray, inp["omega"])
            st = st._replace(omega=omega, heads=jax.tree.map(
                lambda h: jnp.broadcast_to(h, (C * N,) + h.shape),
                inp["head"]))
            if tag:
                st = st._replace(omega_stale=omega)
            if mode == MODES[0]:
                out[tag + "state0"] = _plain(jax.tree.map(np.asarray, st))
            st = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(
                mesh, s)), st, specs, is_leaf=lambda z: isinstance(z, P))
            xb = jax.device_put(inp["x"].reshape(C * N * B, -1),
                                NamedSharding(mesh, bspec[0]))
            yb = jax.device_put(inp["y"].reshape(C * N * B),
                                NamedSharding(mesh, bspec[1]))
            step = jax.jit(step_fn)
            metrics = []
            for s in range(STEPS):
                st, m = step(st, xb, yb, jnp.asarray(inp["keys"][s]))
                metrics.append({k: float(v) for k, v in m.items()})
            out[tag + mode] = {"metrics": metrics,
                               "state": _plain(jax.tree.map(np.asarray, st))}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# --------------------------------------------------------------------------
# the port side (4 gloo ranks)
# --------------------------------------------------------------------------

def _shapes_of_backward(gather, shard, ctx, g_loc):
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Shapes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.shapes.add(tuple(t.shape))
            return out

    full = gather(shard, ctx)
    with _Shapes() as mode:
        torch.autograd.backward(tree_leaves(full), tree_leaves(g_loc))
    return mode.shapes


def _backward_case(mesh, model, g_full, p_dev, mode, live=None):
    """One rank's slab backward on its (cluster, client) cotangents
    (``live``: (C,) cluster flags and N_eff = 1.5)."""
    cidx, cli = mesh.coords["cluster"], mesh.coords["client"]
    specs = {"final": model.final_specs(), "trunk": model.trunk_specs()}
    template = abstract_params(specs)
    axes = tree_leaves(logical_axes(specs))
    gather, packer = make_packed_omega_gather(
        mesh, ("client", "cluster"), ("cluster",), N, C * N, torch.float32,
        template, axes, n_clusters=C, count_mode=mode)
    chan = channel_params(FLConfig(**FL_CHANNEL), n_clusters=C)
    ctx = OTACtx(p_weight=torch.tensor(p_dev[cidx, cli]),
                 key=packed_omega_key(rng.PRNGKey(42)), sigma2=chan.sigma2,
                 h_th=chan.h_threshold, noise_std=chan.noise_std,
                 ota_on=chan.ota_on,
                 live=None if live is None else torch.tensor(live),
                 n_eff=None if live is None else torch.tensor(1.5))
    g_loc = tree_map(lambda l: torch.from_numpy(l[cidx, cli]), g_full)
    shard = tree_unflatten(template, [
        torch.zeros([s // (C * N) if d == a.index("embed") else s
                     for d, s in enumerate(l.shape)] if "embed" in a
                    else list(l.shape), requires_grad=True)
        for l, a in zip(tree_leaves(template), axes)])
    shapes = _shapes_of_backward(gather, shard, ctx, g_loc)
    return ([l.grad.clone() for l in tree_leaves(shard)], shapes,
            packer.size)


def _steps(step_fn, st, x, y, inp, n=STEPS, faults=None):
    metrics = []
    for s in range(n):
        st, m = step_fn(st, x, y, inp["keys"][s], None, faults)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "state": st}


def _fault_runs(mesh, model, x, y, inp, ref_state0):
    """The faulted step in both count modes; zero-rate faults (to hold
    against the unfaulted steps); two total-blackout steps."""
    out = {}
    state0 = tuple(ref_state0) + (inp["omega"], np.float32(0.0))
    for mode in MODES:
        for name, fl_kw in (("faults", FL_FAULTS),
                            ("zero", dict(FL_CHANNEL, faults=True))):
            _, step_fn, specs, _ = make_hota_train_step(
                model, mesh, FLConfig(**fl_kw), TrainConfig(lr=LR),
                loss_kind="cls", n_out=MAXC, count_mode=mode)
            st = hota_state_from_numpy(state0, mesh, mesh.rank, "cpu", specs)
            out[(name, mode)] = _steps(step_fn, st, x, y, inp)
        black = fault_params(FLConfig(**dict(FL_FAULTS, blackout_rate=1.0)))
        out[("blackout", mode)] = dict(
            _steps(step_fn, st, x, y, inp, n=2, faults=black), before=st)
    return out


def _rank(mesh, inp, ref_state0, g_full, p_dev, sim_init):
    torch.set_num_threads(1)
    rng.set_threefry_partitionable(True)
    model = build_model(ModelConfig(family="mlp", compute_dtype="float32"),
                        DIMS)
    cidx, cli = mesh.coords["cluster"], mesh.coords["client"]
    x = inp["x"][cidx, cli]
    y = inp["y"][cidx, cli]
    out = {}
    for mode in MODES:
        _, step_fn, specs, _ = make_hota_train_step(
            model, mesh, FLConfig(**FL_CHANNEL), TrainConfig(lr=LR),
            loss_kind="cls", n_out=MAXC, count_mode=mode)
        st = hota_state_from_numpy(ref_state0, mesh, mesh.rank, "cpu", specs)
        metrics = []
        for s in range(STEPS):
            st, m = step_fn(st, x, y, inp["keys"][s])
            metrics.append({k: float(v) for k, v in m.items()})
        out[mode] = {"metrics": metrics, "state": st}
    # gradient accumulation: two microbatches of half the batch
    _, step_fn, specs, _ = make_hota_train_step(
        model, mesh, FLConfig(**FL_CHANNEL, microbatches=2),
        TrainConfig(lr=LR), loss_kind="cls", n_out=MAXC, count_mode="local")
    st = hota_state_from_numpy(ref_state0, mesh, mesh.rank, "cpu", specs)
    metrics = []
    for s in range(STEPS):
        st, m = step_fn(st, x, y, inp["keys"][s])
        metrics.append({k: float(v) for k, v in m.items()})
    out["mb2"] = {"metrics": metrics, "state": st}
    # dist ≡ sim: channel off, equal weighting
    fl_eq = FLConfig(n_clusters=C, n_clients=N, weighting="equal", ota=False,
                     tau_h=1)
    init_fn, step_fn, specs, _ = make_hota_train_step(
        model, mesh, fl_eq, TrainConfig(lr=LR), loss_kind="cls", n_out=MAXC)
    st = shard_state(sim_init, specs, mesh)
    losses = []
    for s in range(STEPS):
        st, m = step_fn(st, x, y, inp["keys"][s])
        losses.append(float(m["loss"]))
    out["sim"] = {"losses": losses, "omega": st.omega}
    out["fault"] = _fault_runs(mesh, model, x, y, inp, ref_state0)
    # the slab backward on shared keys, both modes, both threefry layouts
    out["bwd"] = {}
    for part in (True, False):
        rng.set_threefry_partitionable(part)
        for mode in MODES:
            out["bwd"][(mode, part)] = _backward_case(
                mesh, model, g_full, p_dev, mode)
    rng.set_threefry_partitionable(True)
    for mode in MODES:
        out["bwd"][(mode, "dead")] = _backward_case(
            mesh, model, g_full, p_dev, mode, live=LIVE)
    return out


def _spec_model():
    return build_model(ModelConfig(family="mlp", compute_dtype="float32"),
                       DIMS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides, once for the module: (reference results, port ranks'
    results, the inputs)."""
    tmp = tmp_path_factory.mktemp("dist")
    ref_path = tmp / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             str(ref_path)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    inp = _inputs()
    # the reference's initial state, rebuilt in numpy: the JAX step's
    # init with the shared ω and heads (zero moments, p = f0 = 1)
    model = _spec_model()
    # the global moment slab: the shard-major concatenation of 4 local
    # slabs (FSDP leaves give their shard, replicated leaves their whole)
    slab = C * N * sum(
        int(np.prod(l.shape)) // (C * N if "embed" in a else 1)
        for l, a in zip(tree_leaves(inp["omega"]), tree_leaves(logical_axes(
            {"final": model.final_specs(), "trunk": model.trunk_specs()}))))
    state0 = (inp["omega"], (np.int32(0), np.zeros(slab, np.float32),
                             np.zeros(slab, np.float32)),
              tree_map(lambda h: np.broadcast_to(h, (C * N,) + h.shape),
                       inp["head"]),
              (np.int32(0), tree_map(
                  lambda h: np.zeros((C * N,) + h.shape, np.float32),
                  inp["head"]), tree_map(
                  lambda h: np.zeros((C * N,) + h.shape, np.float32),
                  inp["head"])),
              np.ones(C * N, np.float32), np.zeros(C * N, np.float32),
              np.zeros(C * N, np.float32), np.int32(0),
              np.ones(C * N, np.float32), np.int32(0))
    r = np.random.default_rng(5)
    g_full = tree_map(lambda l: r.standard_normal(
        (C, N) + tuple(l.shape)).astype(np.float32),
        abstract_params({"final": model.final_specs(),
                         "trunk": model.trunk_specs()}))
    p_dev = r.uniform(0.5, 1.5, (C, N)).astype(np.float32)
    sim_init = _sim_init(inp, slab)
    try:
        ranks = run_ranks(_rank, (inp, state0, g_full, p_dev, sim_init),
                          device="cpu")
    finally:
        log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log[-4000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    return ref, ranks, inp, state0, g_full, p_dev


def _sim_init(inp, slab):
    """A global port HotaState for the dist ≡ sim run (the same ω and
    heads as the sim's)."""
    t = torch.from_numpy
    heads = tree_map(lambda h: t(np.broadcast_to(h, (C * N,) + h.shape)
                                 .copy()), inp["head"])
    zeros = tree_map(torch.zeros_like, heads)
    i32 = torch.zeros((), dtype=torch.int32)
    return HotaState(
        omega=tree_map(t, inp["omega"]),
        opt=SlabAdamState(i32, torch.zeros(slab), torch.zeros(slab)),
        heads=heads, head_opt=AdamState(i32, zeros, tree_map(
            torch.zeros_like, heads)),
        p=torch.ones(C * N), fgn_mu=torch.zeros(C * N),
        fgn_nu=torch.zeros(C * N), fgn_t=i32, f0=torch.ones(C * N),
        step=i32)


def _fault_specs(mode):
    return make_hota_step_parts(
        _spec_model(), _mesh(0), FLConfig(**FL_FAULTS), TrainConfig(lr=LR),
        loss_kind="cls", n_out=MAXC, count_mode=mode).state_specs


def _state_pairs(a, b):
    """(leaf of a, leaf of b) over two port states of one structure."""
    from repro_torch.common.tree import state_map
    pairs = []
    state_map(lambda u, v: pairs.append((u, v)), a, b)
    return pairs


def _mesh(rank):
    return Mesh((C, N), ("cluster", "client"), rank=rank)


def _rel_l2(a, b):
    a = np.concatenate([np.ravel(x) for x in a])
    b = np.concatenate([np.ravel(x) for x in b])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_initial_state_is_the_reference_init(runs):
    """The numpy initial state both sides start from is the reference
    step's own init with the shared ω and heads."""
    ref, _, _, state0, _, _ = runs

    def leaves(x):
        if isinstance(x, dict):
            return [v for k in sorted(x) for v in leaves(x[k])]
        if isinstance(x, tuple):
            return [v for e in x for v in leaves(e)]
        return [] if x is None else [np.asarray(x)]
    got, want = leaves(state0), leaves(ref["state0"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_step_matches_jax(runs, mode):
    ref, ranks, _, _, _, _ = runs
    want_m = ref[mode]["metrics"]
    for r, res in enumerate(ranks):
        got_m = res[mode]["metrics"]
        for s in range(STEPS):
            for k in want_m[s]:
                np.testing.assert_allclose(got_m[s][k], want_m[s][k],
                                           rtol=1e-4, atol=1e-7,
                                           err_msg=f"rank {r} step {s} {k}")
    specs = make_hota_step_parts(
        _spec_model(), _mesh(0), FLConfig(**FL_CHANNEL), TrainConfig(lr=LR),
        loss_kind="cls", n_out=MAXC, count_mode=mode).state_specs
    got_w, want_w, got_mu, want_mu = [], [], [], []
    for r, res in enumerate(ranks):
        st = res[mode]["state"]
        want = hota_state_from_numpy(ref[mode]["state"], _mesh(r), r, "cpu",
                                     specs)
        for f in ("p", "fgn_mu", "fgn_nu", "f0"):
            np.testing.assert_allclose(getattr(st, f).numpy(),
                                       getattr(want, f).numpy(), rtol=1e-4,
                                       atol=1e-7, err_msg=f"rank {r} {f}")
        assert int(st.step) == int(want.step) == STEPS
        assert int(st.fgn_t) == int(want.fgn_t) == STEPS
        got_w += [l.numpy() for l in tree_leaves(st.omega)]
        want_w += [l.numpy() for l in tree_leaves(want.omega)]
        got_mu.append(st.opt.mu.numpy())
        want_mu.append(want.opt.mu.numpy())
    assert _rel_l2(got_w, want_w) < 1e-4
    assert _rel_l2(got_mu, want_mu) < 1e-4


def test_count_modes_agree_bit_for_bit(runs):
    _, ranks, _, _, _, _ = runs
    for res in ranks:
        a, b = res["local"], res["psum"]
        assert a["metrics"] == b["metrics"]
        for x, y in zip(tree_leaves(a["state"].omega),
                        tree_leaves(b["state"].omega)):
            assert torch.equal(x, y)
        assert torch.equal(a["state"].opt.mu, b["state"].opt.mu)


def test_microbatches_average_to_the_full_batch(runs):
    """``fl.microbatches=2``: the masks and AWGN are the same for every
    microbatch, so the averaged estimates are one transmission of the
    averaged gradient: the full-batch step to float rounding (rtol 1e-4;
    ω relative L2 1e-4)."""
    _, ranks, _, _, _, _ = runs
    for r, res in enumerate(ranks):
        for s in range(STEPS):
            for k, v in res["local"]["metrics"][s].items():
                np.testing.assert_allclose(res["mb2"]["metrics"][s][k], v,
                                           rtol=1e-4, atol=1e-7,
                                           err_msg=f"rank {r} step {s} {k}")
        assert _rel_l2([l.numpy() for l in tree_leaves(
            res["mb2"]["state"].omega)], [l.numpy() for l in tree_leaves(
                res["local"]["state"].omega)]) < 1e-4


def test_dist_matches_sim(runs):
    """dist ≡ sim (``tests/dist_programs/dist_vs_sim.py`` for the port):
    with the channel off and equal weighting both reduce to hierarchical
    data-parallel training."""
    _, ranks, inp, _, _, _ = runs
    model = _spec_model()
    fl = FLConfig(n_clusters=C, n_clients=N, weighting="equal", ota=False,
                  tau_h=1)
    sim = HotaSim(model, fl, TrainConfig(lr=LR), [MAXC] * N, device="cpu")
    st = sim.init(rng.PRNGKey(0))
    st = st._replace(
        omega=tree_map(torch.from_numpy, inp["omega"]),
        heads=tree_map(lambda h: torch.from_numpy(np.broadcast_to(
            h, (C, N) + h.shape).copy()), inp["head"]))
    losses = []
    for s in range(STEPS):
        st, m = sim.step(st, inp["x"], inp["y"], inp["keys"][s])
        losses.append(float(m["loss"].mean()))
    for res in ranks:
        np.testing.assert_allclose(res["sim"]["losses"], losses, rtol=0,
                                   atol=2e-4)
    specs = make_hota_step_parts(
        model, _mesh(0), fl, TrainConfig(lr=LR), loss_kind="cls",
        n_out=MAXC).state_specs
    diffs = []
    for r, res in enumerate(ranks):
        want = shard_state(st.omega, specs.omega, _mesh(r))
        diffs += [np.abs(a.numpy() - b.numpy()).ravel() for a, b in zip(
            tree_leaves(res["sim"]["omega"]), tree_leaves(want))]
    diff = np.concatenate(diffs)
    assert diff.max() < 2 * STEPS * LR + 1e-5, diff.max()
    assert float((diff > LR).mean()) < 0.05


@pytest.mark.parametrize("part", [True, False, "dead"],
                         ids=["partitionable", "original", "dead_cluster"])
@pytest.mark.parametrize("mode", MODES)
def test_slab_backward_matches_oracle(runs, mode, part):
    """``dead_cluster``: partial participation (a dead cluster adds neither
    data nor count; N_eff replaces N), partitionable words."""
    _, ranks, _, _, g_full, p_dev = runs
    model = _spec_model()
    kw = {"live": torch.tensor(LIVE), "n_eff": torch.tensor(1.5)} \
        if part == "dead" else {}
    prev = rng.set_threefry_partitionable(part is not False)
    try:
        chan = channel_params(FLConfig(**FL_CHANNEL), n_clusters=C)
        wg = tree_map(lambda l: torch.einsum(
            "cn,cn...->c...", torch.from_numpy(p_dev), torch.from_numpy(l)),
            g_full)
        _, packer = make_packed_omega_gather(
            _mesh(0), ("client", "cluster"), ("cluster",), N, C * N,
            torch.float32, abstract_params({"final": model.final_specs(),
                                            "trunk": model.trunk_specs()}),
            tree_leaves(logical_axes({"final": model.final_specs(),
                                      "trunk": model.trunk_specs()})),
            n_clusters=C, count_mode=mode)
        want = packed_omega_aggregate_ref(
            wg, packed_omega_key(rng.PRNGKey(42)), chan, N, packer, **kw)
    finally:
        rng.set_threefry_partitionable(prev)
    layout = tree_leaves(make_hota_step_parts(
        model, _mesh(0), FLConfig(**FL_CHANNEL), TrainConfig(lr=LR),
        loss_kind="cls", n_out=MAXC).state_specs.omega)
    for r, res in enumerate(ranks):
        got, _, _ = res["bwd"][(mode, part)]
        for g, w, spec in zip(got, tree_leaves(want), layout):
            np.testing.assert_allclose(
                g.numpy(), w[shard_slices(w.shape, spec, _mesh(r))].numpy(),
                rtol=2e-5, atol=1e-6, err_msg=f"rank {r}")


@pytest.mark.parametrize("mode", MODES)
def test_backward_allocates_no_slab(runs, mode):
    """The reference's zero-copy HLO pin: the backward never produces the
    packed (P,) slab or a (C, P) one; the leaves' own shapes show that the
    recorder saw the work."""
    _, ranks, _, _, _, _ = runs
    for res in ranks:
        _, shapes, p_size = res["bwd"][(mode, True)]
        assert (p_size,) not in shapes and (C, p_size) not in shapes
        assert (DIMS[3] // N, DIMS[4]) in shapes     # fc3/w's LAN region


def _fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    return mesh.rank


def test_a_failing_rank_fails_the_run():
    with pytest.raises(Exception, match="rank 1 fails"):
        run_ranks(_fail_on_rank_1, shape=(1, 2), device="cpu", timeout_s=60)


def test_fault_initial_state_is_the_reference_init(runs):
    """The faulted steps start from the reference's faulted init: the
    unfaulted one plus the stale copy (ω) and its age (0)."""
    ref, _, inp, state0, _, _ = runs
    want = ref["faults_state0"]
    assert len(want) == len(state0) + 2
    for a, b in zip(tree_leaves(inp["omega"]), tree_leaves(want[10])):
        np.testing.assert_array_equal(a, b)
    assert float(want[11]) == 0.0


@pytest.mark.parametrize("mode", MODES)
def test_faulted_step_matches_jax(runs, mode):
    """3 faulted steps against the reference's: metrics (``skipped`` and
    ``n_participants`` included), p and the FedGradNorm state within rtol
    1e-4, ω, its stale copy and the slab moments within relative L2
    1e-4, the stale age and the counters exactly."""
    ref, ranks, _, _, _, _ = runs
    want_m = ref["faults_" + mode]["metrics"]
    assert [m["n_participants"] for m in want_m] == [4.0, 3.0, 1.0]
    specs = _fault_specs(mode)
    got_w, want_w, got_s, want_s = [], [], [], []
    for r, res in enumerate(ranks):
        got = res["fault"][("faults", mode)]
        for s in range(STEPS):
            assert set(got["metrics"][s]) == set(want_m[s])
            for k in want_m[s]:
                np.testing.assert_allclose(got["metrics"][s][k],
                                           want_m[s][k], rtol=1e-4,
                                           atol=1e-7,
                                           err_msg=f"rank {r} step {s} {k}")
        st = got["state"]
        want = hota_state_from_numpy(ref["faults_" + mode]["state"],
                                     _mesh(r), r, "cpu", specs)
        for f in ("p", "fgn_mu", "fgn_nu", "f0"):
            np.testing.assert_allclose(getattr(st, f).numpy(),
                                       getattr(want, f).numpy(), rtol=1e-4,
                                       atol=1e-7, err_msg=f"rank {r} {f}")
        for f in ("step", "fgn_t", "stale_age"):
            assert float(getattr(st, f)) == float(getattr(want, f)), f
        assert int(st.head_opt.step) == int(want.head_opt.step)
        np.testing.assert_allclose(st.heads["w"].numpy(),
                                   want.heads["w"].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=f"rank {r} head")
        got_w += [l.numpy() for l in tree_leaves(st.omega)] + [
            st.opt.mu.numpy()]
        want_w += [l.numpy() for l in tree_leaves(want.omega)] + [
            want.opt.mu.numpy()]
        got_s += [l.numpy() for l in tree_leaves(st.omega_stale)]
        want_s += [l.numpy() for l in tree_leaves(want.omega_stale)]
    assert _rel_l2(got_w, want_w) < 1e-4
    assert _rel_l2(got_s, want_s) < 1e-4


@pytest.mark.parametrize("mode", MODES)
def test_zero_rate_faults_match_the_unfaulted_step(runs, mode):
    """faults=True at zero rates: the unfaulted steps bit for bit (every
    participation select and the guard pass the same values through)."""
    _, ranks, _, _, _, _ = runs
    for r, res in enumerate(ranks):
        got, want = res["fault"][("zero", mode)], res[mode]
        for g, w in zip(got["metrics"], want["metrics"]):
            assert g.pop("skipped") == 0.0
            assert g.pop("n_participants") == C * N
            assert g == w, f"rank {r}"
        for a, b in _state_pairs(got["state"]._replace(
                omega_stale=None, stale_age=None), want["state"]):
            assert torch.equal(a, b), f"rank {r}"


@pytest.mark.parametrize("mode", MODES)
def test_blackout_freezes_the_whole_state(runs, mode):
    """Total blackout: both steps skipped with no participant, and every
    leaf of the rank's state (ω, the stale copy, the slab moments, the
    FedGradNorm state, the head and its moments) bit for bit; only
    ``step`` advances."""
    _, ranks, _, _, _, _ = runs
    for r, res in enumerate(ranks):
        run = res["fault"][("blackout", mode)]
        for m in run["metrics"]:
            assert m["skipped"] == 1.0 and m["n_participants"] == 0.0
        after, before = run["state"], run["before"]
        assert int(after.step) == int(before.step) + 2
        pairs = _state_pairs(after._replace(step=None),
                             before._replace(step=None))
        assert len(pairs) > 20
        for a, b in pairs:
            assert torch.equal(a, b), f"rank {r}"


REFUSALS = {
    "per_leaf": (dict(use_pallas_ota=False), {}, "item 13"),
    "faults": (dict(faults=True, use_pallas_ota=False), {},
               "requires the slab engine"),
    "sectioned": (dict(ota_sectioned=True), {}, "item 13"),
    "max_section_rows": (dict(max_section_rows=64), {}, "item 13"),
    "lm_loss": ({}, dict(loss_kind="lm"), "item 14.1"),
    "streaming": (dict(ota_streaming=True), {}, "SIMULATOR engine"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_name_their_item(case):
    fl_kw, kw, match = REFUSALS[case]
    kw = dict({"loss_kind": "cls", "n_out": MAXC}, **kw)
    with pytest.raises((NotImplementedError, ValueError), match=match):
        make_hota_step_parts(_spec_model(), _mesh(0),
                             FLConfig(n_clusters=C, n_clients=N, **fl_kw),
                             TrainConfig(lr=LR), **kw)


def test_mesh_axis_helpers():
    from repro_torch.sharding.mesh_utils import (
        cluster_axes_of, data_axes_of, flat_client_axes, total_clients,
    )
    m = Mesh((2, 3, 2), ("pod", "cluster", "client"), rank=7)
    assert m.coords == {"pod": 1, "cluster": 0, "client": 1}
    assert data_axes_of(m) == flat_client_axes(m) == ("pod", "cluster",
                                                      "client")
    assert cluster_axes_of(m) == ("pod", "cluster")
    assert total_clients(m) == 12
    assert m.axis_index(("client", "cluster")) == 3
    assert m.axis_index(("pod", "cluster")) == 3
    assert shard_slices((12, 5), (("client", "cluster"), None), m) == (
        slice(6, 8), slice(None))


def test_chan_shape_is_checked():
    _, step_fn, _, _ = make_hota_train_step(
        _spec_model(), _mesh(0), FLConfig(n_clusters=C, n_clients=N),
        TrainConfig(lr=LR), loss_kind="cls", n_out=MAXC)
    chan = channel_params(FLConfig(n_clusters=3, n_clients=N))
    with pytest.raises(ValueError, match="n_total_clusters"):
        step_fn(None, None, None, rng.PRNGKey(0), chan)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
