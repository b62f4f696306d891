"""K6 (``ota_mask_count``) and K7 (``ota_channel``) of the distributed step
against the JAX package, and the packed ω̃ gather on 4 CPU gloo ranks.

Inputs are made with numpy and handed to both packages. The JAX kernels
run as the reference's tests run them on the CPU: the Pallas kernels in
interpret mode (``impl="pallas", interpret=True``). The packed ω̃ gather
and ``packed_final_norm`` of the reference run in a ``shard_map`` over 4
forced host devices in a subprocess (this file, run as a program, sets
``XLA_FLAGS`` before importing JAX); the port's run on 4 spawned gloo
ranks. Both packages use the same ``jax_threefry_partitionable`` mode;
the cases that draw words run in both.

Tolerances:
- K6 is exact (masks, counts and the one multiply), at the paper's
  H_th = 0.032 with σ² ∈ {0.5, 1, 2}, where XLA's and PyTorch's float32
  erfc agree, with a dead cluster and with ``ota_on`` = 0.
- K7 thresholds a Box-Muller gain whose log and cos may differ between
  XLA and PyTorch in the last place, so a mask counts as wrong only where
  |h² − H_th| exceeds ``MASK_ULPS`` ulp of H_th; ``out`` is exact where
  the masks agree.
- The packed ω̃ gather's estimate: rtol 2e-5, atol 1e-6 where no cluster's
  h² lies within ``MASK_ULPS`` ulp of H_th (the AWGN is
  ``jax.random.normal``, whose erfinv differs from PyTorch's by up to
  5.7e-6 relative, ROADMAP Queue 3); the masked norms rtol 1e-5.
- The slab oracle ``packed_omega_aggregate_ref``: rtol 1e-5, atol 1e-6.
"""
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.flatpack import packer_for as jpacker_for
from repro.core.channel import channel_params as jchannel_params
from repro.common.config import FLConfig as JFLConfig
from repro.core.hota_slab import (
    packed_omega_aggregate_ref as jpacked_omega_aggregate_ref,
)
from repro.kernels.ota_channel import ops as jops
from repro_torch import rng
from repro_torch.common.config import FLConfig, ModelConfig
from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.core.channel import channel_params
from repro_torch.core.hota import (
    OTACtx, make_packed_final_gather, packed_final_key, packed_final_norm,
)
from repro_torch.core.hota_slab import (
    omega_packer, packed_omega_aggregate_ref,
)
from repro_torch.kernels.ota_channel import ops, ref
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.model import build_model
from repro_torch.models.params import abstract_params, logical_axes
from repro_torch.sharding.mesh_utils import Mesh, shard_slices
from torch_threads import JAX_XLA_FLAGS

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))

H_TH = 0.032
MASK_ULPS = 16
C, N = 2, 2
DIMS = (32, 64, 128, 1152, 64, 32)
FINAL_SIGMA2 = (0.5, 2.0)
NOISE_STD = 0.3
PARTS = (True, False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _set_mode(part: bool):
    """The same threefry layout in both packages; returns the old ones."""
    old = (jax.config.jax_threefry_partitionable,
           rng.threefry_partitionable())
    jax.config.update("jax_threefry_partitionable", part)
    rng.set_threefry_partitionable(part)
    return old


def _restore(old):
    jax.config.update("jax_threefry_partitionable", old[0])
    rng.set_threefry_partitionable(old[1])


def _i32(u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(u32.view(np.int32).copy())


# --------------------------------------------------------------------------
# K6: exact against the interpret-mode Pallas kernel
# --------------------------------------------------------------------------

K6_CASES = {
    "default": dict(live=None, ota_on=1.0),
    "dead_cluster": dict(live=[1.0, 0.0, 1.0], ota_on=1.0),
    "ota_off": dict(live=None, ota_on=0.0),
    "ota_off_dead": dict(live=[0.0, 1.0, 1.0], ota_on=0.0),
}


@pytest.mark.parametrize("n", [3000, 4096])
@pytest.mark.parametrize("me", [0, 2])
@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_k6_plain_matches_pallas(case, me, n):
    kw = K6_CASES[case]
    r = np.random.default_rng(n + me)
    sig = np.asarray([0.5, 1.0, 2.0], np.float32)
    x = r.standard_normal(n).astype(np.float32)
    bits = r.integers(0, 2 ** 32, (3, n), dtype=np.uint64).astype(np.uint32)
    live = None if kw["live"] is None else np.asarray(kw["live"], np.float32)
    want_o, want_c = jops.ota_mask_count_apply(
        jnp.asarray(x), jnp.asarray(bits), jnp.asarray(me), jnp.asarray(sig),
        H_TH, kw["ota_on"], 1.3,
        live_all=None if live is None else jnp.asarray(live),
        impl="pallas", interpret=True)
    got_o, got_c = ops.ota_mask_count_apply(
        torch.from_numpy(x), _i32(bits), me, torch.from_numpy(sig), H_TH,
        kw["ota_on"], 1.3,
        live_all=None if live is None else torch.from_numpy(live))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    if live is not None:        # a dead cluster adds to no count
        assert got_c.max() <= 2.0


def test_k6_plain_reads_strided_rows():
    """A leaf's (C, n) slice of wider (C, section) streams is read in
    place, as the backward passes it."""
    r = np.random.default_rng(3)
    wide = _i32(r.integers(0, 2 ** 32, (3, 5000), dtype=np.uint64)
                .astype(np.uint32))
    x = torch.from_numpy(r.standard_normal(1200).astype(np.float32))
    sig = torch.tensor([0.5, 1.0, 2.0])
    a = ops.ota_mask_count_apply(x, wide[:, 700:1900], 1, sig, H_TH, 1.0, 0.7)
    b = ops.ota_mask_count_apply(x, wide[:, 700:1900].contiguous(), 1, sig,
                                 H_TH, 1.0, 0.7)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_k6_k7_wrappers_refuse_other_devices():
    """A wrapper runs its plain version for CPU tensors only: any other
    device raises rather than falling back."""
    x = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.ota_mask_count_apply(x, torch.empty((2, 8), dtype=torch.int32,
                                                device="meta"), 0,
                                 torch.ones(2), H_TH, 1.0, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        ops._ota_channel_impl(x, torch.empty(8, dtype=torch.int32,
                                             device="meta"), 1.0, H_TH, 1.0)
    with pytest.raises(ValueError, match="cluster 3"):
        ops.ota_mask_count_apply(torch.zeros(8), torch.zeros(
            (2, 8), dtype=torch.int32), 3, torch.ones(2), H_TH, 1.0, 1.0)


# --------------------------------------------------------------------------
# K7: the ulp rule against the interpret-mode Pallas kernel
# --------------------------------------------------------------------------

def _near_threshold(h: np.ndarray, h_th: float) -> np.ndarray:
    ulp = np.spacing(np.float32(h_th))
    return np.abs(h.astype(np.float64) ** 2 - h_th) <= MASK_ULPS * ulp


@pytest.mark.parametrize("ota_on", [1.0, 0.0])
@pytest.mark.parametrize("sigma2", [0.5, 1.0, 2.0])
def test_k7_plain_matches_pallas(sigma2, ota_on):
    rows = 24
    r = np.random.default_rng(int(sigma2 * 10))
    x = r.standard_normal((rows, 128)).astype(np.float32)
    bits = r.integers(0, 2 ** 32, (rows, 128), dtype=np.uint64).astype(
        np.uint32)
    want_o, want_m = jops._ota_channel_impl(
        jnp.asarray(x), jnp.asarray(bits), sigma2, H_TH, ota_on,
        interpret=True)
    got_o, got_m = ops._ota_channel_impl(
        torch.from_numpy(x), _i32(bits), sigma2, H_TH, ota_on)
    h = ref.bits_to_gaussian(_i32(bits), sigma2).numpy()
    agree = got_m.numpy() == np.asarray(want_m)
    assert np.all(agree | _near_threshold(h, H_TH)), \
        "K7 masks differ away from the threshold"
    np.testing.assert_array_equal(got_o.numpy()[agree],
                                  np.asarray(want_o)[agree])
    if ota_on == 0.0:
        assert got_m.numpy().all()


@pytest.mark.parametrize("part", PARTS, ids=["partitionable", "original"])
def test_ota_channel_matches_jax(part):
    """``ota_channel`` on an arbitrary shape: the words of the padded
    (rows, 128) slab the reference draws, in both threefry layouts."""
    old = _set_mode(part)
    try:
        x = np.random.default_rng(1).standard_normal((37, 29)).astype(
            np.float32)
        key = np.asarray([0, 17], np.uint32)
        want_o, want_m = jops.ota_channel(jnp.asarray(x), jnp.asarray(key),
                                          1.0, H_TH, interpret=True)
        got_o, got_m = ops.ota_channel(torch.from_numpy(x), key, 1.0, H_TH)
        pln_o, pln_m = ops.ota_channel_reference(torch.from_numpy(x), key,
                                                 1.0, H_TH)
        jw = np.asarray(jax.random.bits(jnp.asarray(key), (16, 128),
                                        jnp.uint32)).reshape(-1)[:x.size]
        h = ref.bits_to_gaussian(_i32(jw), 1.0).numpy().reshape(x.shape)
    finally:
        _restore(old)
    assert torch.equal(got_o, pln_o) and torch.equal(got_m, pln_m)
    agree = got_m.numpy() == np.asarray(want_m)
    assert np.all(agree | _near_threshold(h, H_TH))
    np.testing.assert_array_equal(got_o.numpy()[agree],
                                  np.asarray(want_o)[agree])


def test_step_keys_match_jax():
    """The distributed step's channel keys: ``fold_tags``,
    ``packed_final_key`` and ``packed_omega_key`` fold the reference's
    registered salts in its order."""
    from repro.core import hota as jhota
    from repro.core import hota_slab as jslab
    from repro_torch.core import hota, hota_slab
    key = np.asarray([5, 1234], np.uint32)
    pairs = [
        (hota.fold_tags(key, "final", (2, 7), 3),
         jhota.fold_tags(jnp.asarray(key), "final", (2, 7), 3)),
        (hota.packed_final_key(key), jhota.packed_final_key(
            jnp.asarray(key))),
        (hota_slab.packed_omega_key(key), jslab.packed_omega_key(
            jnp.asarray(key))),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                      np.asarray(want))


# --------------------------------------------------------------------------
# the slab oracle against the reference's
# --------------------------------------------------------------------------

def _model():
    return build_model(ModelConfig(family="mlp", compute_dtype="float32"),
                       DIMS)


@pytest.mark.parametrize("part", PARTS, ids=["partitionable", "original"])
def test_slab_oracle_matches_jax(part):
    old = _set_mode(part)
    try:
        model = _model()
        template = abstract_params({"final": model.final_specs(),
                                    "trunk": model.trunk_specs()})
        r = np.random.default_rng(11)
        wg = tree_map(lambda l: r.standard_normal(
            (C,) + tuple(l.shape)).astype(np.float32), template)
        key = np.asarray([3, 9], np.uint32)
        live, n_eff = np.asarray([1.0, 0.0], np.float32), 1.5
        jpk = jpacker_for(jax.tree.map(
            lambda l: jax.ShapeDtypeStruct(l.shape[1:], jnp.float32), wg),
            tail="final", sections="toplevel")
        jchan = jchannel_params(JFLConfig(n_clusters=C, sigma2=(0.5, 2.0),
                                          noise_std=NOISE_STD))
        jwg = jax.tree.map(jnp.asarray, wg)
        chan = channel_params(FLConfig(n_clusters=C, sigma2=(0.5, 2.0),
                                       noise_std=NOISE_STD))
        pk = omega_packer(template)
        jref = jax.jit(lambda w, k, **kw: jpacked_omega_aggregate_ref(
            w, k, jchan, N, jpk, **kw))
        for kw in ({}, {"live": live, "n_eff": n_eff}):
            want = jref(jwg, jnp.asarray(key),
                        **{k: jnp.asarray(v) for k, v in kw.items()})
            got = packed_omega_aggregate_ref(
                tree_map(torch.from_numpy, wg), key, chan, N, pk,
                **{k: torch.as_tensor(v) for k, v in kw.items()})
            for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-5, atol=1e-6)
    finally:
        _restore(old)


# --------------------------------------------------------------------------
# the packed ω̃ gather and packed_final_norm, 4 ranks each side
# --------------------------------------------------------------------------

def _final_inputs():
    model = _model()
    r = np.random.default_rng(21)
    g_full = tree_map(lambda l: r.standard_normal(
        (C, N) + tuple(l.shape)).astype(np.float32),
        abstract_params(model.final_specs()))
    p_dev = r.uniform(0.5, 1.5, (C, N)).astype(np.float32)
    return g_full, p_dev, np.asarray([0, 42], np.uint32)


def _jax_main(out_path):
    os.environ["XLA_FLAGS"] = JAX_XLA_FLAGS
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh, PartitionSpec as P

    import repro.models.model as rmodel
    from repro.common.config import ModelConfig as JMC
    from repro.core.hota import (
        OTACtx as JCtx, _is_axes, cluster_index,
        make_packed_final_gather as jgather, packed_final_key as jkey,
        packed_final_norm as jnorm,
    )
    from repro.core.channel import channel_params as jchan_params
    from repro.common.config import FLConfig as JFL
    from repro.models.params import abstract_params as jabs
    from repro.models.params import logical_axes as jaxes
    from repro.sharding.mesh_utils import shard_map_compat

    rmodel.PAPER_MLP_DIMS = DIMS
    model = rmodel.build_model(JMC(family="mlp", compute_dtype="float32"))
    mesh = JMesh(np.array(jax.devices()).reshape(C, N), ("cluster", "client"))
    axes_list = jax.tree.leaves(jaxes(model.final_specs()), is_leaf=_is_axes)
    template = jabs(model.final_specs())
    gather = jgather(("client", "cluster"), ("cluster",), N, C * N,
                     jnp.float32, axes_list, template=template)
    chan = jchan_params(JFL(n_clusters=C, n_clients=N, sigma2=FINAL_SIGMA2,
                            noise_std=NOISE_STD))
    g_full, p_dev, key = _final_inputs()
    out = {}
    for part in PARTS:
        jax.config.update("jax_threefry_partitionable", part)

        def local(g_loc, p_loc):
            g_loc = jax.tree.map(lambda l: l[0], g_loc)
            cidx = cluster_index(("cluster",))
            sig = chan.sigma2[cidx]
            ctx = JCtx(p_weight=p_loc.reshape(()),
                       key=jkey(jnp.asarray(key)), sigma2=sig,
                       h_th=chan.h_threshold, noise_std=chan.noise_std,
                       ota_on=chan.ota_on)
            shard = jax.tree.map(
                lambda l, ax: jnp.zeros(
                    (l.shape[0] // (C * N),) + l.shape[1:]
                    if "embed" in ax else l.shape, jnp.float32),
                g_loc, jax.tree.unflatten(jax.tree.structure(g_loc),
                                          axes_list), is_leaf=_is_axes)
            _, vjp = jax.vjp(lambda t: gather(t, ctx), shard)
            (g_sh,) = vjp(g_loc)
            nrm = jnorm(g_loc, jnp.asarray(key), chan._replace(sigma2=sig),
                        ("cluster",))
            return g_sh, nrm.reshape(1)

        g_dev = jax.tree.map(lambda l: np.swapaxes(l, 0, 1).reshape(
            (N * C,) + l.shape[2:]), g_full)
        spec_in = jax.tree.map(lambda l: P(("client", "cluster")), g_dev)
        out_g = jax.tree.unflatten(
            jax.tree.structure(template),
            [P(("client", "cluster")) if "embed" in ax else P()
             for ax in axes_list])
        f = jax.jit(shard_map_compat(
            local, mesh=mesh, in_specs=(spec_in, P("cluster", "client")),
            out_specs=(out_g, P(("cluster", "client"))),
            axis_names={"cluster", "client"}))
        g_sh, nrm = f(g_dev, jnp.asarray(p_dev))
        out[part] = {"ghat": jax.tree.map(np.asarray, g_sh),
                     "norm": np.asarray(nrm)}
    with open(out_path, "wb") as fh:
        pickle.dump(out, fh)


def _final_rank(mesh, g_full, p_dev, key):
    torch.set_num_threads(1)
    model = _model()
    cidx, cli = mesh.coords["cluster"], mesh.coords["client"]
    axes_list = tree_leaves(logical_axes(model.final_specs()))
    gather = make_packed_final_gather(
        mesh, ("client", "cluster"), ("cluster",), N, C * N, torch.float32,
        axes_list, template=abstract_params(model.final_specs()))
    chan = channel_params(FLConfig(n_clusters=C, n_clients=N,
                                   sigma2=FINAL_SIGMA2, noise_std=NOISE_STD))
    chan_c = chan._replace(sigma2=chan.sigma2[cidx])
    g_loc = tree_map(lambda l: torch.from_numpy(l[cidx, cli]), g_full)
    out = {}
    for part in PARTS:
        rng.set_threefry_partitionable(part)
        ctx = OTACtx(p_weight=torch.tensor(p_dev[cidx, cli]),
                     key=packed_final_key(key), sigma2=chan_c.sigma2,
                     h_th=chan.h_threshold, noise_std=chan.noise_std,
                     ota_on=chan.ota_on)
        shard = tree_unflatten(g_loc, [
            torch.zeros(((l.shape[0] // (C * N),) + tuple(l.shape[1:]))
                        if "embed" in a else tuple(l.shape),
                        requires_grad=True)
            for l, a in zip(tree_leaves(g_loc), axes_list)])
        full = gather(shard, ctx)
        torch.autograd.backward(tree_leaves(full), tree_leaves(g_loc))
        out[part] = {"ghat": [l.grad.clone() for l in tree_leaves(shard)],
                     "norm": float(packed_final_norm(g_loc, key, chan_c,
                                                     cidx))}
    return out


@pytest.fixture(scope="module")
def final_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("final")
    ref_path = tmp / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             str(ref_path)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    g_full, p_dev, key = _final_inputs()
    try:
        ranks = run_ranks(_final_rank, (g_full, p_dev, key), device="cpu")
    finally:
        log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log[-4000:]
    with open(ref_path, "rb") as fh:
        return pickle.load(fh), ranks


def _final_near(key, part) -> np.ndarray:
    """Slab entries where some cluster's h² lies within MASK_ULPS ulp of
    H_th (the K7 ulp rule), from the port's words (bit-identical)."""
    model = _model()
    tpl = tree_map(lambda l: torch.empty(tuple(l.shape), device="meta"),
                   abstract_params(model.final_specs()))
    from repro_torch.common.flatpack import packer_for
    pk = packer_for(tpl, tail=None)
    old = rng.set_threefry_partitionable(part)
    try:
        near = np.zeros(pk.size, bool)
        for c in range(C):
            b = rng.bits(rng.fold_in(packed_final_key(key), c), pk.size)
            near |= _near_threshold(
                ref.bits_to_gaussian(b, FINAL_SIGMA2[c]).numpy(), H_TH)
    finally:
        rng.set_threefry_partitionable(old)
    return tree_leaves(pk.unpack(torch.from_numpy(near)))


@pytest.mark.parametrize("part", PARTS, ids=["partitionable", "original"])
def test_packed_final_gather_matches_jax(final_runs, part):
    want, ranks = final_runs
    _, _, key = _final_inputs()
    near = _final_near(key, part)
    model = _model()
    axes_list = tree_leaves(logical_axes(model.final_specs()))
    for r, res in enumerate(ranks):
        m = Mesh((C, N), ("cluster", "client"), rank=r)
        # the reference's ghat shards come back in ("client", "cluster")
        # order along the FSDP dim, the ranks' in the same order
        for g, w, nr, ax in zip(res[part]["ghat"],
                                jax.tree.leaves(want[part]["ghat"]), near,
                                axes_list):
            spec = (("client", "cluster"),) if "embed" in ax else ()
            sl = shard_slices(w.shape, spec, m)
            ok = ~nr.numpy().astype(bool)[sl]
            assert ok.mean() > 0.99
            np.testing.assert_allclose(g.numpy()[ok], w[sl][ok], rtol=2e-5,
                                       atol=1e-6, err_msg=f"rank {r}")
        np.testing.assert_allclose(
            res[part]["norm"], want[part]["norm"].reshape(C * N)[r],
            rtol=1e-5)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
