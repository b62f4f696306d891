"""The distributed HOTA step with the LM loss, and the training
launcher, on 4 CPU gloo ranks against the JAX package on 4 forced host
devices.

As in ``tests/test_torch_dist.py``: the JAX side runs in a subprocess
(this file, run as a program, with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``) and writes numpy
outputs; the port runs in 4 spawned ranks (``launch.mesh.run_ranks``);
both start from one numpy initial state (``convert.hota_state_from_numpy``
cuts each rank's shards) and see the same token batch and keys. The
model is the reference's ``tests/dist_programs/dist_train_step.py`` one
(2 dense layers, d_model 64, 4 heads over 2, SwiGLU 128, vocab 128,
attention blocks of 16, remat ``nothing_saveable``, float32), 2
sequences of 32 tokens per client.

Cases and tolerances:
- ``loss_kind="lm"`` for 3 steps with the channel on (σ² = (0.5, 2),
  AWGN 0.1, FedGradNorm, τ_h = 1) on the slab engine in both count modes
  ("local": K6's plain version, "psum": K5's), with 2 microbatches, and
  on the per-leaf oracle ("scatter", its hook inside the remat boundary:
  the backward gathers each layer again), each against the reference's
  step: metrics, p and the FedGradNorm state within rtol 1e-4; ω
  within relative L2 1e-3 (a first Adam step moves an entry with |ĝ| at
  float noise by ±lr either way, ROADMAP Queue 3); the two count modes
  bit for bit;
- ``launch.train.main`` (``--device cpu --no-tune-layout --mesh 2,2,1
  --steps 3``, StarCoder2-3B's smoke config) against the reference's
  ``main`` from the same seed: the losses it prints within rtol 1e-4
  (the reference prints 4 decimals); its full-state and final-ω
  checkpoints restore in the reference's ``restore_checkpoint`` and the
  reference's in the port's, each within relative L2 1e-3 of the
  other side's own; ``--mesh 2,1,2`` gives two model replicas whose
  states are equal bit for bit; with ``--faults`` and a spike threshold
  every round trips, the ``RoundGuard`` restores the newest full-state
  checkpoint into every rank and ω ends where it started, bit for bit;
  ``experiments.train_lm_federated``'s rank function at a small width
  prints the example's lines, lowers the loss and writes a checkpoint
  that restores.
"""
import os
import pickle
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.checkpoint.store import restore_checkpoint
from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.convert import hota_state_from_numpy
from repro_torch.core.hota_step import (
    global_like, make_hota_step_parts, make_hota_train_step, shard_state,
)
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.model import build_model
from repro_torch.models.params import logical_axes
from repro_torch.sharding.mesh_utils import Mesh
# one_torch_thread: an autouse fixture
from torch_threads import JAX_XLA_FLAGS, one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))

C, N, B, S, VOCAB = 2, 2, 2, 32, 128
STEPS = 3
LR = 1e-3
MODEL = dict(family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab_size=VOCAB, attn_block_q=16,
             attn_block_kv=16, remat_policy="nothing_saveable",
             compute_dtype="float32")
FL_CHANNEL = dict(n_clusters=C, n_clients=N, sigma2=(0.5, 2.0),
                  noise_std=0.1)
# name -> (FLConfig overrides, count mode)
CASES = {
    "local": ({}, "local"),
    "psum": ({}, "psum"),
    "mb2": ({"microbatches": 2}, "local"),
    "perleaf": ({"use_pallas_ota": False, "ota_mode": "scatter"}, None),
}
LAUNCH = ["--arch", "starcoder2-3b", "--steps", str(STEPS), "--mesh",
          "2,2,1", "--no-tune-layout", "--ckpt-every", "2"]
FULL_STEP, OMEGA_STEP = 2, STEPS      # the launcher's checkpoints


def _inputs():
    """The shared numpy ω, head, token batch and keys."""
    r = np.random.default_rng(0)
    model = build_model(ModelConfig(**MODEL))

    def draw(specs):
        return tree_map(lambda s: (
            np.zeros(s.shape, np.float32) if s.init == "zeros" else
            (r.standard_normal(s.shape) / (1.0 if s.init == "embed" else
                                           np.sqrt(s.shape[-2]))
             ).astype(np.float32)), specs)
    omega = {"final": draw(model.final_specs()),
             "trunk": draw(model.trunk_specs())}
    head = draw(model.head_specs())
    tokens = r.integers(0, VOCAB, (C, N, B, S)).astype(np.int32)
    labels = r.integers(0, VOCAB, (C, N, B, S)).astype(np.int32)
    return {"omega": omega, "head": head, "tokens": tokens,
            "labels": labels, "keys": [np.asarray([0, 11 + s], np.uint32)
                                       for s in range(STEPS)]}


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    return None if x is None else np.asarray(x)


def _slab_len(omega):
    model = build_model(ModelConfig(**MODEL))
    axes = tree_leaves(logical_axes({"final": model.final_specs(),
                                     "trunk": model.trunk_specs()}))
    return C * N * sum(l.size // (C * N if "embed" in a else 1)
                       for l, a in zip(tree_leaves(omega), axes))


def _state0(inp, per_leaf: bool):
    """The reference step's initial state with the shared ω and heads, in
    numpy (zero moments, p = f0 = 1)."""
    zeros = lambda t: tree_map(np.zeros_like, t)   # noqa: E731
    n = _slab_len(inp["omega"])
    opt = ((np.int32(0), zeros(inp["omega"]), zeros(inp["omega"]))
           if per_leaf else (np.int32(0), np.zeros(n, np.float32),
                             np.zeros(n, np.float32)))
    heads = tree_map(lambda h: np.broadcast_to(h, (C * N,) + h.shape).copy(),
                     inp["head"])
    return (inp["omega"], opt, heads,
            (np.int32(0), zeros(heads), zeros(heads)),
            np.ones(C * N, np.float32), np.zeros(C * N, np.float32),
            np.zeros(C * N, np.float32), np.int32(0),
            np.ones(C * N, np.float32), np.int32(0))


# --------------------------------------------------------------------------
# the JAX side (run as a program: 4 forced host devices)
# --------------------------------------------------------------------------

def _jax_steps(out_path):
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    import repro.core.hota_step as hs
    from repro.common.config import FLConfig as JFL
    from repro.common.config import ModelConfig as JMC
    from repro.common.config import TrainConfig as JTC
    from repro.models.model import build_model as jbuild

    model = jbuild(JMC(**MODEL))
    mesh = JMesh(np.array(jax.devices()).reshape(C, N), ("cluster", "client"))
    inp = _inputs()
    orig = hs.make_packed_omega_gather
    out = {}
    for name, (kw, mode) in CASES.items():
        hs.make_packed_omega_gather = partial(orig, count_mode=mode or "psum")
        init_fn, step_fn, specs, bspec = hs.make_hota_train_step(
            model, mesh, JFL(**FL_CHANNEL, **kw), JTC(lr=LR),
            loss_kind="lm")
        st = init_fn(jax.random.PRNGKey(123))
        st = st._replace(omega=jax.tree.map(jnp.asarray, inp["omega"]),
                         heads=jax.tree.map(lambda h: jnp.broadcast_to(
                             h, (C * N,) + h.shape), inp["head"]))
        if name == "perleaf":
            st = st._replace(opt=st.opt._replace(
                mu=jax.tree.map(jnp.zeros_like, st.omega),
                nu=jax.tree.map(jnp.zeros_like, st.omega)))
        out[name + "_state0"] = _plain(jax.tree.map(np.asarray, st))
        st = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(
            mesh, s)), st, specs, is_leaf=lambda z: isinstance(z, P))
        tok = jax.device_put(inp["tokens"].reshape(C * N * B, S),
                             NamedSharding(mesh, bspec[0]))
        lab = jax.device_put(inp["labels"].reshape(C * N * B, S),
                             NamedSharding(mesh, bspec[1]))
        step = jax.jit(step_fn)
        metrics = []
        for s in range(STEPS):
            st, m = step(st, tok, lab, jnp.asarray(inp["keys"][s]))
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = {"metrics": metrics,
                     "state": _plain(jax.tree.map(np.asarray, st))}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _jax_launcher(out_path, ckpt_dir, port_dir, port_done):
    """The reference's ``main`` on the launcher's flags; then, once the
    port's run has written ``port_done``, both runs' checkpoints restored
    through the reference's ``restore_checkpoint``."""
    import jax
    from jax.sharding import Mesh as JMesh

    from repro.checkpoint.store import restore_checkpoint as jrestore
    from repro.common.config import FLConfig as JFL
    from repro.common.config import TrainConfig as JTC
    from repro.configs import get_smoke_config
    from repro.core.hota_step import make_hota_train_step as jstep
    from repro.launch import train as jtrain
    from repro.models.model import build_model as jbuild

    sys.argv = ["train"] + LAUNCH + ["--ckpt-dir", ckpt_dir]
    jtrain.main()
    model = jbuild(get_smoke_config("starcoder2_3b"))
    mesh = JMesh(np.array(jax.devices()).reshape(C, N, 1),
                 ("cluster", "client", "model"))
    init_fn, _, _, _ = jstep(model, mesh, JFL(n_clusters=C, n_clients=N,
                                              noise_std=0.1),
                             JTC(lr=LR), loss_kind="lm")
    like = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    deadline = time.time() + 600
    while not os.path.exists(port_done):
        if time.time() > deadline:
            raise TimeoutError("the port's launcher run never finished")
        time.sleep(0.2)
    out = {}
    for tag, d in (("ref", ckpt_dir), ("port", port_dir)):
        out[tag] = {
            "full": _plain(jax.tree.map(np.asarray, jrestore(
                d, FULL_STEP, like))),
            "omega": _plain(jax.tree.map(np.asarray, jrestore(
                d, OMEGA_STEP, like.omega)))}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


# --------------------------------------------------------------------------
# the port side (4 gloo ranks)
# --------------------------------------------------------------------------

def _rank(mesh, inp):
    torch.set_num_threads(1)
    model = build_model(ModelConfig(**MODEL))
    cidx, cli = mesh.coords["cluster"], mesh.coords["client"]
    out = {}
    for name, (kw, mode) in CASES.items():
        _, step_fn, specs, _ = make_hota_train_step(
            model, mesh, FLConfig(**FL_CHANNEL, **kw), TrainConfig(lr=LR),
            loss_kind="lm", count_mode=mode)
        st = hota_state_from_numpy(_state0(inp, name == "perleaf"), mesh,
                                   mesh.rank, "cpu", specs)
        metrics = []
        for s in range(STEPS):
            st, m = step_fn(st, inp["tokens"][cidx, cli],
                            inp["labels"][cidx, cli], inp["keys"][s])
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = {"metrics": metrics, "state": st}
    return out


def _env():
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep
                + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_lm")
    ref_path = tmp / "ref.pkl"
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "steps", str(ref_path)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    inp = _inputs()
    try:
        ranks = run_ranks(_rank, (inp,), device="cpu", timeout_s=300)
    finally:
        log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log[-4000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    return ref, ranks


def _mesh(rank, shape=(C, N), axes=("cluster", "client")):
    return Mesh(shape, axes, rank=rank)


def _rel_l2(a, b):
    a = np.concatenate([np.ravel(x) for x in a])
    b = np.concatenate([np.ravel(x) for x in b])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_initial_states_are_the_reference_init(runs):
    ref, _ = runs
    inp = _inputs()
    for name in CASES:
        got = _state0(inp, name == "perleaf")

        def leaves(x):
            if isinstance(x, dict):
                return [v for k in sorted(x) for v in leaves(x[k])]
            if isinstance(x, tuple):
                return [v for e in x for v in leaves(e)]
            return [] if x is None else [np.asarray(x)]
        a, b = leaves(got), leaves(ref[name + "_state0"])
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            assert x.shape == y.shape and x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lm_step_matches_jax(runs, case):
    ref, ranks = runs
    kw, mode = CASES[case]
    want_m = ref[case]["metrics"]
    specs = make_hota_step_parts(
        build_model(ModelConfig(**MODEL)), _mesh(0),
        FLConfig(**FL_CHANNEL, **kw), TrainConfig(lr=LR), loss_kind="lm",
        count_mode=mode).state_specs
    got_w, want_w = [], []
    for r, res in enumerate(ranks):
        got_m = res[case]["metrics"]
        for s in range(STEPS):
            assert got_m[s].keys() == want_m[s].keys()
            for k in want_m[s]:
                np.testing.assert_allclose(got_m[s][k], want_m[s][k],
                                           rtol=1e-4, atol=1e-7,
                                           err_msg=f"rank {r} step {s} {k}")
        st = res[case]["state"]
        want = hota_state_from_numpy(ref[case]["state"], _mesh(r), r, "cpu",
                                     specs)
        for f in ("p", "fgn_mu", "fgn_nu", "f0"):
            np.testing.assert_allclose(getattr(st, f).numpy(),
                                       getattr(want, f).numpy(), rtol=1e-4,
                                       atol=1e-7, err_msg=f"rank {r} {f}")
        assert int(st.step) == int(want.step) == STEPS
        got_w += [l.numpy() for l in tree_leaves(st.omega)]
        want_w += [l.numpy() for l in tree_leaves(want.omega)]
    assert _rel_l2(got_w, want_w) < 1e-3
    # the loss fell and FedGradNorm kept Σp = N
    losses = [m["loss"] for m in ranks[0][case]["metrics"]]
    assert losses[-1] < losses[0], losses
    assert abs(ranks[0][case]["metrics"][-1]["p_mean"] * N - N) < 1e-3


def test_lm_count_modes_agree_bit_for_bit(runs):
    _, ranks = runs
    for res in ranks:
        a, b = res["local"], res["psum"]
        assert a["metrics"] == b["metrics"]
        for x, y in zip(tree_leaves(a["state"].omega),
                        tree_leaves(b["state"].omega)):
            assert torch.equal(x, y)
        assert torch.equal(a["state"].opt.mu, b["state"].opt.mu)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The reference's ``main`` (subprocess) and the port's (4 CPU ranks)
    on the same flags, each with its own checkpoint directory."""
    tmp = tmp_path_factory.mktemp("launch")
    ref_dir, port_dir = str(tmp / "ref"), str(tmp / "port")
    done, out = str(tmp / "port_done"), str(tmp / "ref.pkl")
    env = dict(_env(), XLA_FLAGS=JAX_XLA_FLAGS)
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "launcher", out, ref_dir,
         port_dir, done], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        ranks = train_mod.main(LAUNCH + ["--ckpt-dir", port_dir, "--device",
                                         "cpu"])
        open(done, "w").close()
    finally:
        log, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, log[-4000:]
    with open(out, "rb") as f:
        restored = pickle.load(f)
    return ranks, log, restored, ref_dir, port_dir


def test_launcher_losses_match_the_reference(launched):
    ranks, log, _, _, _ = launched
    printed = {int(s): float(v) for s, v in re.findall(
        r"^step +(\d+) loss ([-\d.]+) ", log, re.M)}
    assert sorted(printed) == [0, STEPS - 1], log[-2000:]
    for s, want in printed.items():
        got = ranks[0]["metrics"][s]["loss"]
        assert abs(got - want) <= 1e-4 * abs(want) + 5e-5, (s, got, want)
    for res in ranks:       # every rank's metrics are the mesh's means
        assert res["metrics"] == ranks[0]["metrics"]


def _launch_specs(rank=0):
    model = train_mod._model("starcoder2-3b")
    return make_hota_step_parts(
        model, _mesh(rank, (C, N, 1), train_mod.MESH_AXES),
        FLConfig(n_clusters=C, n_clients=N, noise_std=0.1),
        TrainConfig(lr=LR), loss_kind="lm").state_specs


def test_launcher_checkpoints_restore_both_ways(launched):
    """The port's full-state and ω checkpoints restore in the reference
    within relative L2 1e-3 of the reference's own, and the reference's
    restore in the port within the same of the port's."""
    ranks, _, restored, ref_dir, port_dir = launched
    for what in ("full", "omega"):
        a = [x for x in _np_leaves(restored["port"][what])]
        b = [x for x in _np_leaves(restored["ref"][what])]
        assert [x.shape for x in a] == [x.shape for x in b], what
        assert [x.dtype for x in a] == [x.dtype for x in b], what
        assert _rel_l2(a, b) < 1e-3, what
    like = global_like(ranks[0]["state"], _launch_specs(), _mesh(
        0, (C, N, 1), train_mod.MESH_AXES))
    for step, tree in ((FULL_STEP, like), (OMEGA_STEP, like.omega)):
        mine = restore_checkpoint(port_dir, step, tree)
        theirs = restore_checkpoint(ref_dir, step, tree)
        a, b = _np_leaves(mine), _np_leaves(theirs)
        assert _rel_l2(a, b) < 1e-3, step
    # the final ω checkpoint is the ranks' shards gathered, bit for bit
    omega = restore_checkpoint(port_dir, OMEGA_STEP, like.omega)
    specs = _launch_specs()
    for r, res in enumerate(ranks):
        want = shard_state(omega, specs.omega, _mesh(r, (C, N, 1),
                                                     train_mod.MESH_AXES))
        for x, y in zip(tree_leaves(res["state"].omega), tree_leaves(want)):
            assert torch.equal(x, y)


def test_vision_embeddings_step_matches_jax():
    """Phi-3-vision's smoke config (float32): the vision stub's (B, S,
    d_model) float embeddings through one step of the port's step on one
    rank, against the reference's ``make_hota_train_step`` on one device
    from the same state, embeddings, labels and keys. Tolerances as in
    ``test_lm_step_matches_jax``; the heads (trained in the τ_h phase) within
    relative L2 1e-3 as ω."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh

    import repro.core.hota_step as hs
    from repro.common.config import FLConfig as JFL
    from repro.common.config import TrainConfig as JTC
    from repro.configs import get_smoke_config as jget_smoke
    from repro.models.model import build_model as jbuild
    from repro_torch.configs import get_smoke_config

    arch, fl = "phi3_vision_4_2b", dict(n_clusters=1, n_clients=1,
                                        sigma2=(0.5,), noise_std=0.1)
    jm = jbuild(jget_smoke(arch))
    cfg = get_smoke_config(arch)
    assert cfg.modality == "vision" and cfg.compute_dtype == "float32"
    r = np.random.default_rng(5)
    emb = r.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    labels = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    keys = [np.asarray([0, 21], np.uint32)]

    init_fn, step_fn, _, _ = hs.make_hota_train_step(
        jm, JMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                  ("cluster", "client")), JFL(**fl), JTC(lr=LR),
        loss_kind="lm")
    st = init_fn(jax.random.PRNGKey(7))
    state0 = _plain(jax.tree.map(np.asarray, st))
    step = jax.jit(step_fn)
    want_m = []
    for k in keys:
        st, m = step(st, jnp.asarray(emb), jnp.asarray(labels),
                     jnp.asarray(k))
        want_m.append({n: float(v) for n, v in m.items()})
    want = _plain(jax.tree.map(np.asarray, st))

    mesh = Mesh((1, 1), ("cluster", "client"))
    _, pstep, specs, _ = make_hota_train_step(
        build_model(cfg), mesh, FLConfig(**fl), TrainConfig(lr=LR),
        loss_kind="lm")
    got = hota_state_from_numpy(state0, mesh, 0, "cpu", specs)
    for k, wm in zip(keys, want_m):
        got, m = pstep(got, torch.from_numpy(emb), labels, k)
        assert m.keys() == wm.keys()
        for n in wm:
            np.testing.assert_allclose(float(m[n]), wm[n], rtol=1e-4,
                                       atol=1e-7, err_msg=n)
    want = hota_state_from_numpy(want, mesh, 0, "cpu", specs)
    for f in ("p", "fgn_mu", "fgn_nu", "f0"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(want, f).numpy(), rtol=1e-4,
                                   atol=1e-7, err_msg=f)
    for f in ("omega", "heads"):
        assert _rel_l2([t.numpy() for t in tree_leaves(getattr(got, f))],
                       [t.numpy() for t in tree_leaves(getattr(want, f))]
                       ) < 1e-3, f


def _np_leaves(tree):
    from repro_torch.checkpoint.store import flatten
    return [np.asarray(x.numpy() if torch.is_tensor(x) else x)
            for x in flatten(tree)]


def test_model_axis_replicas_are_identical():
    ranks = train_mod.main(["--arch", "starcoder2-3b", "--steps", "2",
                            "--mesh", "2,1,2", "--no-tune-layout",
                            "--device", "cpu"])
    mesh = Mesh((2, 1, 2), train_mod.MESH_AXES)
    for r in range(mesh.size):
        twin = r ^ 1            # the same (cluster, client), other model
        assert mesh.axis_index("model", r) != mesh.axis_index("model", twin)
        a, b = ranks[r], ranks[twin]
        assert a["metrics"] == b["metrics"]
        for x, y in zip(tree_leaves(a["state"].omega) + [a["state"].p],
                        tree_leaves(b["state"].omega) + [b["state"].p]):
            assert torch.equal(x, y)
    assert ranks[0]["metrics"][-1]["loss"] < ranks[0]["metrics"][0]["loss"]


def test_launcher_round_guard_restores(tmp_path, capfd):
    """``--faults`` with a spike threshold every round trips: each round
    is skipped, and with ``--guard-patience 1`` the ``RoundGuard``
    restores the newest full-state checkpoint, which every rank cuts
    again: ω ends where it started, bit for bit."""
    ckpt = str(tmp_path / "ckpt")
    ranks = train_mod.main(["--arch", "starcoder2-3b", "--steps", "3",
                            "--mesh", "2,2,1", "--no-tune-layout",
                            "--device", "cpu", "--faults", "--spike-norm",
                            "1e-30", "--guard-patience", "1", "--ckpt-dir",
                            ckpt, "--ckpt-every", "1"])
    out = capfd.readouterr().out
    # round 0 finds no checkpoint yet; rounds 1 and 2 restore step 1
    assert re.findall(r"^step +(\d+) RoundGuard: 1 consecutive skipped "
                      r"rounds — restored from checkpoint step (\d+)$",
                      out, re.M) == [("1", "1"), ("2", "1")]
    assert [m["skipped"] for m in ranks[0]["metrics"]] == [1.0] * 3
    for r, res in enumerate(ranks):
        init = make_hota_step_parts(
            train_mod._model("starcoder2-3b"),
            Mesh((C, N, 1), train_mod.MESH_AXES, rank=r),
            FLConfig(n_clusters=C, n_clients=N, noise_std=0.1, faults=True),
            TrainConfig(lr=LR), loss_kind="lm").init_fn(rng.PRNGKey(0))
        for x, y in zip(tree_leaves(res["state"].omega),
                        tree_leaves(init.omega)):
            assert torch.equal(x, y)


def test_federated_example_runs_and_checkpoints(tmp_path, capfd):
    """``experiments.train_lm_federated``'s rank function on 4 CPU ranks
    at a small width of the same family (the example's own ``lm-100m``
    runs on the card, ``chip_smoke.py`` phase 30): the example's lines,
    a falling loss, and a checkpoint of the global ω with its
    ``params_m`` that restores into the model's shapes."""
    from repro_torch.checkpoint.store import checkpoint_metadata
    from repro_torch.experiments import train_lm_federated as ex
    from repro_torch.models.params import abstract_params, param_count
    cfg = ex.LM_100M.replace(n_layers=2, d_model=64, n_heads=4,
                             n_kv_heads=2, d_ff=128, vocab_size=512,
                             attn_block_q=16, attn_block_kv=16)
    args = ex.parser().parse_args(["--steps", "3", "--seq-len", "32",
                                   "--out", str(tmp_path), "--device",
                                   "cpu"])
    ranks = run_ranks(ex.train_rank, (args, cfg), shape=(C, N, 1),
                      axes=train_mod.MESH_AXES, device="cpu")
    out = capfd.readouterr().out
    model = build_model(cfg)
    n_params = param_count({"t": model.trunk_specs()})
    assert f"model: {n_params/1e6:.1f}M shared params" in out
    assert len(re.findall(r"^round +\d+ \| loss ", out, re.M)) == 2
    assert ranks[0][-1] < ranks[0][0] and all(r == ranks[0] for r in ranks)
    assert checkpoint_metadata(str(tmp_path), 3) == {
        "params_m": n_params / 1e6}
    omega = restore_checkpoint(str(tmp_path), 3, abstract_params(
        {"final": model.final_specs(), "trunk": model.trunk_specs()}))
    assert all(bool(torch.isfinite(l).all()) for l in tree_leaves(omega))


if __name__ == "__main__":
    if sys.argv[1] == "steps":
        os.environ["XLA_FLAGS"] = JAX_XLA_FLAGS
        _jax_steps(sys.argv[2])
    else:
        _jax_launcher(*sys.argv[2:])
