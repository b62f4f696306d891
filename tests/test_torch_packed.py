"""The port's packed OTA engine (``ota_aggregate_packed``, K3's and K4's
plain versions, ``TreePacker.pack``/``unpack``) against the JAX package.

Inputs are made with numpy and handed to both packages; the JAX side runs
as its suite runs on the CPU (the Pallas kernels in interpret mode, the
jnp references). Both threefry layouts are exercised by setting
``jax_threefry_partitionable`` and the port's mode together.

Tolerances: stream words exact; ĝ rtol 1e-5, atol 1e-6 (Box-Muller's
log/cos and the cluster sum differ in the last bits between XLA and
PyTorch). Masks are exact except where the uniform lies within one ulp
of p_pass: at σ² = 0.05 XLA's and PyTorch's float32 ``erfc`` differ by
one ulp, so there ĝ is compared only at entries no cluster has within
one ulp (the 1-ulp mask rule).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import FLConfig as JFLConfig
from repro.common.flatpack import packer_for as jpacker_for
from repro.core import ota as jota
from repro.core.channel import channel_params as jchannel_params
from repro.kernels.ota_channel import ref as jref
from repro.kernels.ota_channel.ops import (
    ota_aggregate as jota_aggregate,
    ota_aggregate_reference as jota_aggregate_reference,
)
from repro_torch import rng
from repro_torch.common.config import FLConfig
from repro_torch.common.flatpack import packer_for
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.core import ota
from repro_torch.core.channel import (
    channel_params, scenario_channel, stack_channel_params,
)
from repro_torch.kernels.ota_channel import ops, ref

C, N = 3, 2
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


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def threefry_mode(request):
    """Both packages in one ``jax_threefry_partitionable`` layout."""
    prev_jax = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    prev = rng.set_threefry_partitionable(request.param)
    yield request.param
    rng.set_threefry_partitionable(prev)
    jax.config.update("jax_threefry_partitionable", prev_jax)


def _tree(seed, c=C, fc1_rows=1100):
    """A (C, ...) weighted-gradient tree in the sim's ω layout; fc1 spans
    more than one 131072-word chunk, so streams cross a chunk boundary."""
    r = np.random.default_rng(seed)

    def a(*shape):
        return r.normal(size=(c,) + shape).astype(np.float32)
    return {"final": {"w": a(40, 8), "b": a(8)},
            "trunk": {"fc0": {"w": a(30, 50), "b": a(50)},
                      "fc1": {"w": a(fc1_rows, 130), "b": a(130)}}}


def _pair(tree, sections="tail", **kw):
    """(JAX tree, JAX packer, port tree, port packer) of one numpy tree."""
    jt = jax.tree.map(jnp.asarray, tree)
    jp = jpacker_for(jax.tree.map(
        lambda l: jax.ShapeDtypeStruct(l.shape[1:], l.dtype), jt),
        tail="final", sections=sections, **kw)
    tt = tree_map(torch.from_numpy, tree)
    tp = packer_for(tree_map(lambda l: l[0], tt), tail="final",
                    sections=sections, **kw)
    return jt, jp, tt, tp


def _chans(**kw):
    base = dict(n_clusters=C, n_clients=N, sigma2=(0.5, 1.0, 2.0),
                noise_std=0.7)
    base.update(kw)
    return jchannel_params(JFLConfig(**base)), channel_params(FLConfig(**base))


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, np.asarray(k)


def _i32(x):
    return torch.from_numpy(np.asarray(x).view(np.int32).copy())


LAYOUTS = {"tail": dict(sections="tail"),
           "toplevel": dict(sections="toplevel"),
           "toplevel_split": dict(sections="toplevel", max_section_rows=512)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pack_unpack_match_jax(layout):
    jt, jp, tt, tp = _pair(_tree(0), **LAYOUTS[layout])
    slab = tp.pack(tt)
    assert slab.dtype == torch.float32
    np.testing.assert_array_equal(slab.numpy(), np.asarray(jp.pack(jt)))
    assert tp.n_rows == jp.n_rows
    assert tp.peak_section_rows() == jp.peak_section_rows()
    back = tp.unpack(slab)
    for a, b in zip(tree_leaves(back), tree_leaves(tt)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # leaves come back in their slot dtype
    half = packer_for({"final": {"w": torch.zeros(4, 3, dtype=torch.float16)},
                       "trunk": {"w": torch.zeros(5)}})
    out = half.unpack(torch.ones(half.size))
    assert out["final"]["w"].dtype == torch.float16
    assert out["trunk"]["w"].dtype == torch.float32


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_packed_bits_match_jax(threefry_mode, layout):
    _, jp, _, tp = _pair(_tree(1), **LAYOUTS[layout])
    jk, tk = _key(3)
    want_g = np.asarray(jota.packed_gain_bits(jk, jp, C))
    want_n = np.asarray(jota.packed_noise_bits(jk, jp))
    got_g = ota.packed_gain_bits(tk, tp, C)
    got_n = ota.packed_noise_bits(tk, tp)
    assert got_g.shape == (C, tp.size) and got_n.shape == (tp.size,)
    assert np.array_equal(got_g.numpy(), want_g.view(np.int32))
    assert np.array_equal(got_n.numpy(), want_n.view(np.int32))


def _near(bits, sigma2, h_th=3.2e-2):
    """(C, P) entries whose uniform lies within one ulp of XLA's p_pass."""
    pp = np.asarray(jref.pass_probability(
        jnp.asarray(sigma2, jnp.float32), h_th)).astype(np.float32)
    u = bits.astype(np.float32) * np.float32(2.0 ** -32)
    return np.abs(u - pp[:, None]) <= np.spacing(pp)[:, None]


@pytest.mark.parametrize("layout,sigma2", [
    ("tail", (0.5, 1.0, 2.0)), ("toplevel", (0.05, 1.0, 2.0))],
    ids=["tail", "toplevel_harsh"])
def test_packed_matches_jax(threefry_mode, layout, sigma2):
    """Both bits modes of the port (plain versions of K4 and K3) against
    the reference's packed engine (its Pallas kernel in interpret mode)."""
    jt, jp, tt, tp = _pair(_tree(2), **LAYOUTS[layout])
    jchan, tchan = _chans(sigma2=sigma2)
    jk, tk = _key(21)
    want = np.asarray(jp.pack(jota.ota_aggregate_packed(jk, jt, jchan, N,
                                                        jp)))
    ok = ~_near(np.asarray(jota.packed_gain_bits(jk, jp, C)),
                sigma2).any(axis=0)
    got = {}
    for mode in ("fused", "supplied"):
        got[mode] = tp.pack(ota.ota_aggregate_packed(tk, tt, tchan, N, tp,
                                                     bits_mode=mode)).numpy()
        np.testing.assert_allclose(got[mode][ok], want[ok], rtol=RTOL,
                                   atol=ATOL)
    assert np.array_equal(got["fused"], got["supplied"])
    if all(s != 0.05 for s in sigma2):
        assert ok.all()


def test_ota_aggregate_matches_jax_on_shared_bits():
    """K3's plain version (``ops.ota_aggregate``) against the reference's
    ``ota_aggregate`` (Pallas, interpret mode) and its jnp oracle on the
    same words, with the masks exact away from p_pass."""
    r = np.random.default_rng(4)
    p = 3 * 1024
    wg = r.normal(size=(C, p)).astype(np.float32)
    bits = r.integers(0, 2 ** 32, size=(C, p), dtype=np.uint32)
    nbits = r.integers(0, 2 ** 32, size=(p,), dtype=np.uint32)
    sig = np.asarray((0.05, 1.0, 2.0), np.float32)
    args = (jnp.asarray(sig), 0.032, 0.7, 1.0, N)
    want_k = np.asarray(jota_aggregate(jnp.asarray(wg), jnp.asarray(bits),
                                       jnp.asarray(nbits), *args))
    want_r = np.asarray(jota_aggregate_reference(
        jnp.asarray(wg), jnp.asarray(bits), jnp.asarray(nbits), *args))
    got = ops.ota_aggregate(torch.from_numpy(wg), _i32(bits), _i32(nbits),
                            torch.from_numpy(sig), 0.032, 0.7, 1.0, N).numpy()
    near = _near(bits, sig)
    jm = np.asarray(jref.bits_to_mask(jnp.asarray(bits),
                                      jnp.asarray(sig)[:, None], 0.032))
    tm = ref.bits_to_mask(_i32(bits), torch.from_numpy(sig)[:, None],
                          0.032).numpy()
    assert np.array_equal(jm[~near], tm[~near])
    ok = ~near.any(axis=0)
    for want in (want_k, want_r):
        np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=ATOL)


def test_packed_ota_off_is_weighted_mean():
    """``ota_on`` off: every mask passes and the AWGN is zero, so ĝ is the
    plain mean Σ_l wg_l / (C·N)."""
    _, _, tt, tp = _pair(_tree(5), sections="toplevel")
    _, tchan = _chans(ota=False, noise_std=7.0)
    for mode in ("fused", "supplied"):
        ghat = ota.ota_aggregate_packed(rng.PRNGKey(2), tt, tchan, N, tp,
                                        bits_mode=mode)
        for g, w in zip(tree_leaves(ghat), tree_leaves(tt)):
            np.testing.assert_allclose(g.numpy(), w.sum(0).numpy() / (C * N),
                                       rtol=1e-6, atol=1e-7)


def test_packed_all_blocked_is_exact_zero():
    """σ² → 0 with H_th > 0: no entry passes, so ĝ is exactly 0, never
    noise / (cnt·N) and never NaN."""
    _, _, tt, tp = _pair(_tree(6), sections="tail")
    tt = tree_map(lambda l: torch.full_like(l, 1e6), tt)
    _, tchan = _chans(h_threshold=0.5, noise_std=5.0, sigma2=(1e-14,))
    for mode in ("fused", "supplied"):
        for leaf in tree_leaves(ota.ota_aggregate_packed(
                rng.PRNGKey(11), tt, tchan, N, tp, bits_mode=mode)):
            assert torch.equal(leaf, torch.zeros_like(leaf))


def test_client_folded_matches_einsum_plus_packed():
    """The reference's ``test_client_folded_matches_einsum_plus_packed`` on
    the port: the client-folded engine on raw (C, N, ...) gradients equals
    the packed engine on the einsum-weighted tree, on the same
    "toplevel" packer."""
    r = np.random.default_rng(7)
    g = {k: torch.from_numpy(r.normal(size=(C, N) + s).astype(np.float32))
         for k, s in (("b", (8,)), ("w", (40, 8)))}
    grads = {"final": g, "trunk": {"fc0": {
        "w": torch.from_numpy(r.normal(size=(C, N, 300, 500))
                              .astype(np.float32)),
        "b": torch.from_numpy(r.normal(size=(C, N, 500)).astype(np.float32))}}}
    p = torch.from_numpy(r.uniform(0.5, 1.5, (C, N)).astype(np.float32))
    _, tchan = _chans()
    packer = packer_for(tree_map(lambda l: l[0, 0], grads), tail="final",
                        sections="toplevel")
    key = rng.PRNGKey(13)
    folded = ota.ota_aggregate_client_folded(key, grads, p, tchan, N, packer)
    weighted = tree_map(lambda l: torch.einsum("cn,cn...->c...", p, l), grads)
    packed = ota.ota_aggregate_packed(key, weighted, tchan, N, packer)
    for a, b in zip(tree_leaves(folded), tree_leaves(packed)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


def test_banked_supplied_draw_matches_single_calls():
    """The banked use: the words drawn once, then one whole-slab K3
    estimate per scenario of a stacked ChannelParams bank, equal to each
    scenario's own packed call."""
    _, _, tt, tp = _pair(_tree(8), sections="toplevel")
    bank = stack_channel_params([
        channel_params(FLConfig(n_clusters=C, n_clients=N)),
        channel_params(FLConfig(n_clusters=C, n_clients=N,
                                sigma2=(0.05, 1.0, 1.0))),
        channel_params(FLConfig(n_clusters=C, n_clients=N, ota=False))])
    key = rng.PRNGKey(3)
    wg = tp.pack(tt)
    bits = ota.packed_gain_bits(key, tp, C)
    nbits = ota.packed_noise_bits(key, tp)
    for s in range(3):
        chan = scenario_channel(bank, s)
        banked = tp.unpack(ops.ota_aggregate(wg, bits, nbits, *chan[:4], N))
        one = ota.ota_aggregate_packed(key, tt, chan, N, tp)
        for a, b in zip(tree_leaves(banked), tree_leaves(one)):
            assert torch.equal(a, b)


def test_packed_section_keys_match_jax():
    """The (S, 2, 2) [gain, AWGN] key table K4 reads per section."""
    _, jp, _, tp = _pair(_tree(9), sections="toplevel")
    jk, tk = _key(17)
    nk = jota.noise_key(jk)
    want = np.stack([np.stack([np.asarray(jax.random.fold_in(jk, f)),
                               np.asarray(jax.random.fold_in(nk, f))])
                     for f in jota.packed_section_folds(jp)])
    got = ota.packed_section_keys(tk, tp)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_packed_refuses_bad_input():
    _, _, tt, tp = _pair(_tree(10), sections="tail")
    _, tchan = _chans()
    with pytest.raises(ValueError, match="bits_mode"):
        ota.ota_aggregate_packed(rng.PRNGKey(0), tt, tchan, N, tp,
                                 bits_mode="bogus")
    bad = {"final": tt["final"], "trunk": {"fc0": tt["trunk"]["fc0"]}}
    with pytest.raises(ValueError, match="packed OTA"):
        ota.ota_aggregate_packed(rng.PRNGKey(0), bad, tchan, N, tp)
    wg = torch.zeros((C, 8), device="meta")
    with pytest.raises(ValueError):
        ops.ota_aggregate(wg, torch.zeros((C, 8), dtype=torch.int32,
                                          device="meta"),
                          torch.zeros(8, dtype=torch.int32, device="meta"),
                          torch.ones(C), 0.032, 1.0, 1.0, N)
    with pytest.raises(ValueError, match="supply both"):
        ops._ota_aggregate_fused_impl(torch.zeros(C, 8), torch.zeros(1, 2, 2),
                                      [8], torch.ones(C), 0.032, 1.0, 1.0, N,
                                      bits=torch.zeros((C, 8),
                                                       dtype=torch.int32))
