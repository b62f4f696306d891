"""The distributed HOTA step with the LM loss on the Zamba2 hybrid (its
smoke config), on 4 CPU gloo ranks against the JAX package on 4 forced
host devices; and the port's axes registry on the hybrid.

As in ``tests/test_torch_dist_lm.py``: the JAX side runs in a subprocess
(this file, run as a program, with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``) and writes numpy
outputs; the port runs in 4 ranks (``launch.mesh.run_ranks``); both
start from one numpy initial state (``convert.hota_state_from_numpy``
cuts each rank's shards) and see the same token batch and keys. The
model is ``zamba2-1.2b``'s smoke config (5 Mamba2 layers, d_model 128,
the shared attention + MLP block after every 2nd layer: 2 applications
of one parameter set, window 32, float32, remat "none"), 2 sequences of
64 tokens per client (two 32-token windows, four 16-step SSD chunks), so
the step cuts the Mamba2 and shared leaves on their "embed" dim
(``w_in`` axis 0, ``w_out`` axis 1; ``conv_w`` and the per-head
vectors replicated) and, on the per-leaf oracle, gathers the shared
block once per pass: its channel is drawn once and autograd sums both
applications' cotangents before the OTA reduction of eq. (8).

``loss_kind="lm"`` for 2 steps with the channel on (σ² = (0.5, 2), AWGN
0.1, FedGradNorm) in count mode "local" (K6's plain version) and on the
per-leaf oracle ("scatter"), each against the reference's step: metrics,
p and the FedGradNorm state within rtol 1e-4; ω within relative L2 1e-3
(a first Adam step moves an entry with |ĝ| at float noise by ±lr either
way, ROADMAP Queue 3).
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.common.config import FLConfig, TrainConfig
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs import get_smoke_config
from repro_torch.convert import hota_state_from_numpy
from repro_torch.core.hota import _fsdp_axis, build_axes_registry
from repro_torch.core.hota_step import (
    make_hota_step_parts, make_hota_train_step,
)
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.model import build_model
from repro_torch.models.params import logical_axes
from repro_torch.sharding.mesh_utils import Mesh
# one_torch_thread: an autouse fixture
from torch_threads import JAX_XLA_FLAGS, one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))

C, N, B, S = 2, 2, 2, 64
STEPS = 1
LR = 1e-3
ARCH = "zamba2_1_2b"
FL_CHANNEL = dict(n_clusters=C, n_clients=N, sigma2=(0.5, 2.0),
                  noise_std=0.1)
# name -> (FLConfig overrides, count mode)
CASES = {
    "local": ({}, "local"),
    "perleaf": ({"use_pallas_ota": False, "ota_mode": "scatter"}, None),
}


def _inputs():
    """The shared numpy ω, head, token batch and keys."""
    r = np.random.default_rng(0)
    model = build_model(get_smoke_config(ARCH))
    vocab = model.cfg.vocab_size

    def draw(specs):
        return tree_map(lambda s: (
            np.zeros(s.shape, np.float32) if s.init == "zeros" else
            (r.standard_normal(s.shape) * (
                s.scale or (1.0 if s.init == "embed"
                            else 1.0 / np.sqrt(s.shape[-2])))
             ).astype(np.float32)), specs)
    omega = {"final": draw(model.final_specs()),
             "trunk": draw(model.trunk_specs())}
    head = draw(model.head_specs())
    tokens = r.integers(0, vocab, (C, N, B, S)).astype(np.int32)
    labels = r.integers(0, vocab, (C, N, B, S)).astype(np.int32)
    return {"omega": omega, "head": head, "tokens": tokens,
            "labels": labels, "keys": [np.asarray([0, 21 + s], np.uint32)
                                       for s in range(STEPS)]}


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    return None if x is None else np.asarray(x)


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
    from repro.common.config import TrainConfig as JTC
    from repro.configs import get_smoke_config as jcfg
    from repro.models.model import build_model as jbuild

    model = jbuild(jcfg(ARCH))
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


# --------------------------------------------------------------------------
# the port side (4 gloo ranks)
# --------------------------------------------------------------------------

def _rank(mesh, inp, state0):
    torch.set_num_threads(1)
    model = build_model(get_smoke_config(ARCH))
    cidx, cli = mesh.coords["cluster"], mesh.coords["client"]
    out = {}
    for name, (kw, mode) in CASES.items():
        _, step_fn, specs, _ = make_hota_train_step(
            model, mesh, FLConfig(**FL_CHANNEL, **kw), TrainConfig(lr=LR),
            loss_kind="lm", count_mode=mode)
        st = hota_state_from_numpy(state0[name], mesh, mesh.rank, "cpu",
                                   specs)
        metrics = []
        for s in range(STEPS):
            st, m = step_fn(st, inp["tokens"][cidx, cli],
                            inp["labels"][cidx, cli], inp["keys"][s])
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = {"metrics": metrics, "state": st}
    return out


def _env():
    return dict(os.environ, PYTHONPATH=SRC + os.pathsep
                + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
                XLA_FLAGS=JAX_XLA_FLAGS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's steps first (its initial states feed the ranks),
    then the port's on 4 ranks."""
    tmp = tmp_path_factory.mktemp("dist_hybrid")
    ref_path = tmp / "ref.pkl"
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(ref_path)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    state0 = {name: ref[name + "_state0"] for name in CASES}
    ranks = run_ranks(_rank, (_inputs(), state0), device="cpu",
                      timeout_s=300)
    return ref, ranks


def _mesh(rank):
    return Mesh((C, N), ("cluster", "client"), rank=rank)


def _rel_l2(a, b):
    a = np.concatenate([np.ravel(x) for x in a])
    b = np.concatenate([np.ravel(x) for x in b])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("case", sorted(CASES))
def test_hybrid_lm_step_matches_jax(runs, case):
    ref, ranks = runs
    kw, mode = CASES[case]
    want_m = ref[case]["metrics"]
    specs = make_hota_step_parts(
        build_model(get_smoke_config(ARCH)), _mesh(0),
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


def test_registry_covers_trunk_leaves():
    """The registry holds one axes tuple per leaf the hook sees: the
    embedding, one Mamba2 layer's leaves ("mamba"), the shared block's
    attention and MLP once each, the final norm; the FSDP cut is each
    leaf's "embed" dim."""
    model = build_model(get_smoke_config(ARCH))
    reg = build_axes_registry(model)
    ax = logical_axes(model.trunk_specs())
    assert sorted(reg) == ["embed", "final", "mamba", "shared_attn",
                           "shared_mlp"]
    assert reg["embed"] == [ax["embed"]]
    for klass in ("mamba", "shared_attn", "shared_mlp"):
        assert reg[klass] == tree_leaves(ax[klass])
    assert len(reg["mamba"]) == 9 and len(reg["shared_attn"]) == 5
    assert len(reg["final"]) == len(tree_leaves(model.final_specs()))
    assert {k: _fsdp_axis(v) for k, v in ax["mamba"].items()} == {
        "norm": 0, "w_in": 0, "conv_w": -1, "conv_b": -1, "a_log": -1,
        "d_skip": -1, "dt_bias": -1, "out_norm": -1, "w_out": 1}


if __name__ == "__main__":
    _jax_steps(sys.argv[1])
