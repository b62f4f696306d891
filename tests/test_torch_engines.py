"""The port's streaming and sectioned OTA engines and K5's plain version
against the JAX package, and the reference's equivalences held inside the
port.

Inputs are made with numpy and handed to both packages; the port's
threefry mode is set to the live JAX mode. The JAX side runs as its suite
runs on the CPU: K5 as the Pallas kernel in interpret mode, the engines
with the jnp references of their kernels.

Tolerances:
- K5 (mask and weighted apply) is exact: one compare and one multiply.
  At σ² = 0.05 XLA's and PyTorch's float32 ``erfc`` differ by one ulp, so
  there masks are exact only where the uniform lies more than one ulp
  from p_pass (the 1-ulp mask rule).
- Engine estimates ĝ against JAX: rtol 1e-5, atol 1e-6 (Box-Muller's
  log/cos and the summation order differ in the last bits).
- Inside the port: sectioned ≡ client-folded and sectioned + streaming ≡
  streaming bit for bit; streaming ≈ client-folded to rtol 1e-5, atol
  1e-6 (the cross-cluster sum runs in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.common.config import FLConfig as JFLConfig
from repro.common.flatpack import packer_for as jpacker_for
from repro.core import ota as jota
from repro.core.channel import channel_params as jchannel_params
from repro.kernels.ota_channel import ops as jops
from repro.kernels.ota_channel import ref as jref
from repro.kernels.ota_channel.kernel import ota_mask_weight_pallas
from repro_torch import rng
from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
from repro_torch.common.flatpack import packer_for
from repro_torch.common.tree import tree_leaves
from repro_torch.core import ota
from repro_torch.core.channel import channel_params
from repro_torch.core.sim import HotaSim
from repro_torch.kernels.ota_channel import ref
from repro_torch.kernels.ota_channel.ops import (
    ota_mask_weight_apply, ota_stream_fold_apply,
)
from repro_torch.models.model import build_model

C, N = 3, 2
SIGMA2 = (1.0, 0.5, 2.0)
H_TH = 3.2e-2
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread_and_jax_mode():
    """One intra-op thread (the suite runs several worker processes at
    once), and the port's threefry layout set to the live JAX mode."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    prev_mode = rng.set_threefry_partitionable(
        jax.config.jax_threefry_partitionable)
    yield
    rng.set_threefry_partitionable(prev_mode)
    torch.set_num_threads(prev)


def _t(x):
    if x.dtype == np.uint32:
        return torch.from_numpy(x.view(np.int32).copy())
    return torch.from_numpy(np.array(x))


def _uniform(bits):
    return bits.astype(np.float32) * np.float32(2.0 ** -32)


def _near_threshold(bits, sigma2):
    """Entries whose uniform lies within one ulp of XLA's p_pass."""
    pp = np.float32(jref.pass_probability(jnp.float32(sigma2), H_TH))
    return np.abs(_uniform(bits) - pp) <= np.spacing(pp)


# ---------------------------------------------------------------- K5

# (n, sigma2, ota_on, w)
K5_CASES = {
    "default_ragged": (3 * 1024 + 77, 1.0, 1.0, 1.0),
    "ota_off": (2048 + 5, 0.5, 0.0, 1.0),
    "weighted": (1024 + 300, 2.0, 1.0, 0.37),
    "harsh_sigma": (4096 + 11, 0.05, 1.0, 0.37),
}


@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_k5_plain_matches_jax_pallas(case):
    n, sigma2, ota_on, w = K5_CASES[case]
    r = np.random.default_rng(n)
    x = r.normal(size=n).astype(np.float32)
    bits = r.integers(0, 2 ** 32, size=n, dtype=np.uint32)
    want_o, want_m = (np.asarray(a) for a in jops.ota_mask_weight_apply(
        jnp.asarray(x), jnp.asarray(bits), sigma2, H_TH, ota_on, w,
        impl="pallas", interpret=True))
    # the TPU kernel itself on the lane-aligned body
    main = n - n % 1024
    params = jnp.asarray([[sigma2, H_TH, ota_on, w]], jnp.float32)
    k_o, k_m = ota_mask_weight_pallas(
        jnp.asarray(x[:main]).reshape(-1, 128),
        jnp.asarray(bits[:main]).reshape(-1, 128), params, interpret=True)
    assert np.array_equal(np.asarray(k_o).reshape(-1), want_o[:main])
    assert np.array_equal(np.asarray(k_m).reshape(-1), want_m[:main])

    got_o, got_m = ref.ota_mask_weight_ref(
        _t(x), _t(bits), torch.tensor(sigma2), torch.tensor(H_TH),
        torch.tensor(ota_on), torch.tensor(w))
    wrapped = ota_mask_weight_apply(_t(x), _t(bits), sigma2, H_TH, ota_on, w)
    assert torch.equal(wrapped[0], got_o) and torch.equal(wrapped[1], got_m)
    got_o, got_m = got_o.numpy(), got_m.numpy()
    assert got_o.dtype == got_m.dtype == np.float32 and got_o.shape == (n,)
    ok = ~_near_threshold(bits, sigma2) if ota_on else np.ones(n, bool)
    assert np.array_equal(got_m[ok], want_m[ok])
    assert np.array_equal(got_o[ok], want_o[ok])
    if sigma2 == 0.05:   # the two libraries' erfc differ by one ulp here
        tp = float(ref.pass_probability(torch.tensor(0.05),
                                        torch.tensor(H_TH)))
        jp = float(jref.pass_probability(jnp.float32(0.05), H_TH))
        assert abs(tp - jp) <= np.spacing(np.float32(jp))


def test_k5_wrapper_takes_strided_rows():
    """A 2-D x reads its bits through a row stride: a column slice of a
    wider stream gives the same result as a contiguous copy."""
    r = np.random.default_rng(5)
    x = r.normal(size=(C, 700)).astype(np.float32)
    wide = r.integers(0, 2 ** 32, size=(C, 900), dtype=np.uint32)
    sl = _t(wide)[:, 64:764]
    a = ota_mask_weight_apply(_t(x), sl, 1.0, H_TH, 1.0, 0.5)
    b = ota_mask_weight_apply(_t(x), sl.contiguous(), 1.0, H_TH, 1.0, 0.5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="do not match"):
        ota_mask_weight_apply(_t(x), _t(wide), 1.0, H_TH, 1.0, 0.5)


def test_k5_wrappers_refuse_other_devices():
    """K5's wrappers run the plain version only for CPU tensors; anything
    else either launches the kernel (CUDA) or raises."""
    x = torch.empty((N, 8), device="meta")
    b = torch.empty((8,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ota_mask_weight_apply(x[0], b, 1.0, H_TH, 1.0, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        ota_stream_fold_apply(x, torch.ones(N, device="meta"), b, 1.0, H_TH,
                              1.0)


@pytest.mark.parametrize("live_c", [None, 1.0, 0.0])
def test_stream_fold_plain_matches_jax(live_c):
    r = np.random.default_rng(7)
    g = r.normal(size=(N, 30, 50)).astype(np.float32) * 1e-2
    p_c = r.uniform(0.5, 1.5, size=N).astype(np.float32)
    bits = r.integers(0, 2 ** 32, size=1500, dtype=np.uint32)
    jl = None if live_c is None else jnp.float32(live_c)
    got = ota_stream_fold_apply(
        _t(g), _t(p_c), _t(bits), torch.tensor(0.5), torch.tensor(H_TH),
        torch.tensor(1.0), live_c=None if live_c is None
        else torch.tensor(live_c))
    for impl in ("pallas", "jnp"):
        want = jops.ota_stream_fold_apply(
            jnp.asarray(g), jnp.asarray(p_c), jnp.asarray(bits), 0.5, H_TH,
            1.0, live_c=jl, impl=impl, interpret=True)
        for a, b in zip(got, want):
            assert a.shape == (30, 50)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                       atol=1e-9)
    if live_c == 0.0:
        assert not got[0].any() and not got[1].any()


# ------------------------------------------------------------ engines

SHAPES = {"final": {"w": (40, 8), "b": (8,)},
          "trunk": {"fc0": {"w": (30, 50), "b": (50,)},
                    "fc1": {"w": (50, 40), "b": (40,)}}}


def _shape_map(fn):
    return jax.tree.map(fn, SHAPES, is_leaf=lambda s: isinstance(s, tuple))


def _setup(max_section_rows=0, live=None, n_eff=None):
    r = np.random.default_rng(1)
    g = _shape_map(lambda s: r.normal(size=(C, N) + s).astype(np.float32))
    r = np.random.default_rng(2)
    p = r.uniform(0.5, 1.5, size=(C, N)).astype(np.float32)
    key = np.asarray(jax.random.PRNGKey(11))
    fl = dict(n_clusters=C, n_clients=N, sigma2=SIGMA2, noise_std=0.7)
    jpk = jpacker_for(_shape_map(lambda s: jax.ShapeDtypeStruct(
        s, jnp.float32)), tail="final", sections="toplevel",
        max_section_rows=max_section_rows)
    tg = jax.tree.map(torch.from_numpy, g)
    pk = packer_for(SHAPES, tail="final", sections="toplevel",
                    max_section_rows=max_section_rows)
    assert len(pk.sections) == len(jpk.sections)
    jkw = dict(live=None if live is None else jnp.asarray(live, jnp.float32),
               n_eff=None if n_eff is None else jnp.float32(n_eff))
    kw = dict(live=None if live is None else torch.tensor(live),
              n_eff=None if n_eff is None else torch.tensor(n_eff))
    jargs = (jnp.asarray(key), g, jnp.asarray(p),
             jchannel_params(JFLConfig(**fl)), N, jpk)
    args = (key, tg, torch.from_numpy(p),
            channel_params(FLConfig(**fl)), N, pk)
    return jargs, jkw, args, kw


ENGINES = {
    "streaming": (jota.ota_aggregate_streaming, ota.ota_aggregate_streaming,
                  {}),
    "sectioned": (jota.ota_aggregate_sectioned, ota.ota_aggregate_sectioned,
                  {"streaming": False}),
    "sectioned_streaming": (jota.ota_aggregate_sectioned,
                            ota.ota_aggregate_sectioned,
                            {"streaming": True}),
}
LAYOUTS = {"whole": (0, None, None), "split": (8, None, None),
           "live": (8, (1.0, 0.0, 1.0), 1.5)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_engine_matches_jax(engine, layout):
    jfn, fn, ekw = ENGINES[engine]
    jargs, jkw, args, kw = _setup(*LAYOUTS[layout])
    want = jax.jit(lambda k, g, p: jfn(k, g, p, *jargs[3:], **jkw, **ekw))(
        *jargs[:3])
    got = fn(*args, **kw, **ekw)
    got_l, want_l = tree_leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l) == 6
    for a, b in zip(got_l, want_l):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_port_engine_equivalences(layout):
    _, _, args, kw = _setup(*LAYOUTS[layout])
    folded = tree_leaves(ota.ota_aggregate_client_folded(*args, **kw))
    streamed = tree_leaves(ota.ota_aggregate_streaming(*args, **kw))
    sec = tree_leaves(ota.ota_aggregate_sectioned(*args, **kw))
    sec_st = tree_leaves(ota.ota_aggregate_sectioned(*args, **kw,
                                                     streaming=True))
    for f, s, a, b in zip(folded, streamed, sec, sec_st):
        assert torch.equal(a, f)           # sectioned ≡ client-folded
        assert torch.equal(b, s)           # sectioned+streaming ≡ streaming
        np.testing.assert_allclose(s.numpy(), f.numpy(), rtol=RTOL,
                                   atol=ATOL)


def test_supplied_streams_equal_fused_draw():
    _, _, args, kw = _setup(8)
    key, _, _, chan, _, pk = args
    streams = ota.section_streams(key, pk, C)
    fused = ota.ota_aggregate_client_folded(*args)
    supplied = ota.ota_aggregate_client_folded(*args, bits_mode="supplied",
                                               streams=streams)
    for a, b in zip(tree_leaves(fused), tree_leaves(supplied)):
        assert torch.equal(a, b)
    m_drawn = ota.final_layer_masks_packed(key, chan, pk)
    m_read = ota.final_layer_masks_packed(key, chan, pk, gain=streams.gain)
    for a, b in zip(tree_leaves(m_drawn), tree_leaves(m_read)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="supplied"):
        ota.ota_aggregate_client_folded(*args, bits_mode="supplied")
    with pytest.raises(ValueError, match="fused"):
        ota.ota_aggregate_client_folded(*args, streams=streams)
    with pytest.raises(ValueError, match="bits_mode"):
        ota.ota_aggregate_streaming(*args, bits_mode="packed")


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an operation produces."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


def _produced_shapes(fn, *args, **kw):
    with _Shapes() as mode:
        fn(*args, **kw)
    return mode.shapes


@pytest.mark.parametrize("engine", ["streaming", "sectioned_streaming"])
def test_streaming_engines_hold_one_cluster(engine):
    """The memory contract of the reference's HLO pins
    (test_streaming_hlo_holds_one_cluster,
    test_sectioned_streaming_hlo_holds_one_cluster_one_section): no
    tensor with a (C, section-length), (C, P) or (C, CHUNK) shape is
    produced. Positive control: the all-clusters engines produce one."""
    _, _, args, kw = _setup(8)
    pk = args[-1]
    cluster_shapes = {(C, L) for L in [s.length for s in pk.sections]
                      + [pk.size, ota.CHUNK]}
    _, fn, ekw = ENGINES[engine]
    shapes = _produced_shapes(fn, *args, **ekw)
    assert not shapes & cluster_shapes, shapes & cluster_shapes
    assert SHAPES["trunk"]["fc1"]["w"] in shapes    # the recorder saw ops
    for ctrl, ckw in ((ota.ota_aggregate_client_folded, {}),
                      (ota.ota_aggregate_sectioned, {"streaming": False})):
        assert _produced_shapes(ctrl, *args, **ckw) & cluster_shapes


# --------------------------------------------------------- sim gates

DIMS = (32, 64, 128, 64, 32, 16)


def _sim(**gate):
    return HotaSim(build_model(ModelConfig(family="mlp"), DIMS),
                   FLConfig(n_clusters=C, n_clients=N, **gate), TrainConfig(),
                   [6, 8], device="cpu")


@pytest.mark.parametrize("gate, match", [
    (dict(ota_sectioned=True, use_pallas_ota=False), "ota_sectioned"),
    (dict(ota_sectioned=True, ota_sections="tail"), "multi-section"),
    (dict(max_section_rows=8, use_pallas_ota=False), "max_section_rows"),
], ids=["sectioned_without_slab", "sectioned_on_tail", "split_without_slab"])
def test_sim_refuses_what_the_reference_refuses(gate, match):
    with pytest.raises(ValueError, match=match):
        _sim(**gate)


@pytest.mark.parametrize("gate", [
    dict(ota_streaming=True), dict(ota_sectioned=True),
    dict(ota_sectioned=True, ota_streaming=True),
    dict(max_section_rows=8), dict(ota_streaming=True, ota_sections="tail")],
    ids=["streaming", "sectioned", "sectioned_streaming", "split",
         "streaming_tail"])
def test_sim_runs_each_engine(gate):
    """Each engine the reference accepts runs a round here, and matches
    the client-folded round on the same layout (bit for bit when
    sectioned without streaming)."""
    base = {k: v for k, v in gate.items()
            if k in ("max_section_rows", "ota_sections")}
    r = np.random.default_rng(0)
    xb = r.normal(size=(C, N, 4, DIMS[0])).astype(np.float32)
    yb = r.integers(0, 6, size=(C, N, 4)).astype(np.int32)
    out = []
    for kw in (gate, base):
        sim = _sim(**kw)
        new, m = sim.step(sim.init(rng.PRNGKey(0)), xb, yb, rng.PRNGKey(3))
        out.append((new.ps_opt.mu, m))
    (mu, m), (mu0, m0) = out
    assert torch.isfinite(mu).all() and m["loss"].shape == (C, N)
    for k in m:
        assert torch.equal(m[k], m0[k])     # the channel moves ω only
    if gate.get("ota_streaming"):
        np.testing.assert_allclose(mu.numpy(), mu0.numpy(), rtol=RTOL,
                                   atol=1e-7)
    else:
        assert torch.equal(mu, mu0)


def test_step_streams_are_checked():
    sim = _sim()
    st = sim.init(rng.PRNGKey(0))
    r = np.random.default_rng(1)
    xb = r.normal(size=(C, N, 4, DIMS[0])).astype(np.float32)
    yb = r.integers(0, 6, size=(C, N, 4)).astype(np.int32)
    key = rng.PRNGKey(4)
    streams = sim.round_streams(key, st.omega)
    a = sim.step_with_channel(st, xb, yb, key, sim.chan,
                              ota_bits_mode="supplied", streams=streams)
    b = sim.step(st, xb, yb, key)
    assert torch.equal(a[0].ps_opt.mu, b[0].ps_opt.mu)
    with pytest.raises(ValueError, match="needs the round's streams"):
        sim.step_with_channel(st, xb, yb, key, sim.chan,
                              ota_bits_mode="supplied")
    with pytest.raises(ValueError, match="streams are read only"):
        _sim(ota_streaming=True).step_with_channel(
            st, xb, yb, key, sim.chan, ota_bits_mode="supplied",
            streams=streams)
    with pytest.raises(ValueError, match="draw their streams"):
        _sim(ota_sectioned=True).round_streams(key, st.omega)
