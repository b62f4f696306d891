"""The port's threefry streams against ``jax.random`` and ``repro.core.ota``.

The channel is defined by its random streams (DESIGN.md §4), so the port
must draw the same uint32 words as the reference: every comparison here is
exact, in both values of ``jax_threefry_partitionable``. The mode fixture
restores both flags, since other test files may run in the same worker.
The §4 golden digests (recorded by ``tests/test_stream_spec.py`` under
``jax_threefry_partitionable=False``) are checked against the port in
that mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_stream_spec as spec

from repro.common.flatpack import packer_for as jax_packer_for
from repro.core import ota as jota
from repro.models.model import Model as JaxModel
from repro.common.config import ModelConfig as JaxModelConfig
from repro_torch import rng
from repro_torch.common.flatpack import packer_for
from repro_torch.core import ota
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def threefry_mode(request):
    prev_jax = jax.config.jax_threefry_partitionable
    prev_port = rng.set_threefry_partitionable(request.param)
    try:
        jax.config.update("jax_threefry_partitionable", request.param)
        yield request.param
    finally:
        jax.config.update("jax_threefry_partitionable", prev_jax)
        rng.set_threefry_partitionable(prev_port)


def _u32(t):
    return t.numpy().astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_prngkey_fold_in_bits_exact(threefry_mode, seed):
    k = jax.random.PRNGKey(seed)
    assert np.array_equal(np.asarray(k), _u32(rng.PRNGKey(seed)))
    for data in (0, 3, jota.SIM_CHAN_FOLD, jota.NOISE_FOLD, 0xFFFFFFFF):
        assert np.array_equal(np.asarray(jax.random.fold_in(k, data)),
                              _u32(rng.fold_in(np.asarray(k), data)))
    for n in (1, 2, 7, 1000, 4097):
        want = np.asarray(jax.random.bits(k, (n,), jnp.uint32))
        got = rng.bits(np.asarray(k), n).numpy().view(np.uint32)
        assert np.array_equal(want, got), (n, threefry_mode)


def test_batched_key_table_matches_per_key_draws(threefry_mode):
    """40,003 words of 4 keys span three of the host draw's blocks (on
    the module's one thread it hashes 2**16 words of all keys at a time),
    the last one ragged."""
    base = jax.random.PRNGKey(3)
    keys = np.stack([np.asarray(jax.random.fold_in(base, i))
                     for i in range(4)])
    for n in (300, 40_003):
        got = rng.bits(keys, n).numpy().view(np.uint32)
        for i in range(4):
            want = np.asarray(jax.random.bits(jnp.asarray(keys[i]), (n,),
                                              jnp.uint32))
            assert np.array_equal(got[i], want), n


@pytest.mark.parametrize("start,length", [
    (ota.CHUNK - 100, 300),          # straddles the chunk boundary
    (0, 1500),
    (2 * ota.CHUNK + 17, 5)])
def test_stream_range_bits_exact(threefry_mode, start, length):
    key = jax.random.fold_in(jax.random.PRNGKey(11), 5)
    want = np.asarray(jota.stream_range_bits(key, start, length))
    got = ota.stream_range_bits(np.asarray(key), start, length)
    assert np.array_equal(want, got.numpy().view(np.uint32))


def _paper_packers(sections="toplevel"):
    m = JaxModel(JaxModelConfig(family="mlp"))
    shapes = {"final": m.final_specs(), "trunk": m.trunk_specs()}
    tpl = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32),
                       shapes, is_leaf=lambda s: hasattr(s, "axes"))
    jp = jax_packer_for(tpl, tail="final", sections=sections)
    tp = packer_for(jax.tree.map(lambda s: s.shape, tpl), tail="final",
                    sections=sections)
    return jp, tp


def _check_section_streams(sections):
    jp, tp = _paper_packers(sections)
    key = jota.sim_channel_key(jax.random.PRNGKey(1))
    assert np.array_equal(np.asarray(key),
                          _u32(ota.sim_channel_key(
                              np.asarray(jax.random.PRNGKey(1)))))
    want_g, want_n = jax.jit(lambda k: (jota.section_gain_streams(k, jp, 1),
                                        jota.section_noise_streams(k, jp)))(key)
    got_g = ota.section_gain_streams(np.asarray(key), tp, 1)
    got_n = ota.section_noise_streams(np.asarray(key), tp)
    assert len(want_g) == len(got_g) == len(tp.sections)
    for w, g in zip(want_g, got_g):
        assert np.array_equal(np.asarray(w), g.numpy().view(np.uint32))
    for w, g in zip(want_n, got_n):
        assert np.array_equal(np.asarray(w), g.numpy().view(np.uint32))


def test_section_streams_exact_paper_mlp(threefry_mode):
    """Every section's gain (cluster 0) and AWGN words for the full-width paper
    MLP's "toplevel" layout, under the round's channel key."""
    _check_section_streams("toplevel")


def test_section_streams_exact_two_section_layout():
    """The same for the two-section ("tail") layout's head/tail folds."""
    _check_section_streams("tail")


def test_registry_constants_match_reference():
    names = [n for n in dir(jota) if n.isupper() and (
        "FOLD" in n or "SALT" in n)] + ["CHUNK", "CHUNK_ROWS"]
    for name in names:
        assert getattr(ota, name) == getattr(jota, name), name


@pytest.fixture
def original_mode():
    """The mode the DESIGN.md §4 golden digests were recorded in."""
    prev = rng.set_threefry_partitionable(False)
    try:
        yield
    finally:
        rng.set_threefry_partitionable(prev)


@pytest.mark.parametrize("name", sorted(spec.GOLDEN_GAIN_U32))
def test_spec_golden_stream_digests(original_mode, name):
    """The port draws the §4 spec's first gain and noise words of every
    reserved fold (cluster 0, PRNGKey(0))."""
    key, fold = rng.PRNGKey(0), spec.FOLD_VALUES[name]
    gain = ota.stream_range_bits(ota.section_gain_key(key, fold, 0), 0, 4)
    noise = ota.stream_range_bits(ota.section_noise_key(key, fold), 0, 4)
    assert int(_u32(gain)[0]) == spec.GOLDEN_GAIN_U32[name]
    assert int(_u32(noise)[0]) == spec.GOLDEN_NOISE_U32[name]


@pytest.mark.parametrize("name", sorted(spec.GOLDEN_AUX_U32))
def test_spec_golden_aux_digests(original_mode, name):
    key = rng.fold_in(rng.PRNGKey(0), spec.AUX_VALUES[name])
    assert int(_u32(rng.bits(key, 4))[0]) == spec.GOLDEN_AUX_U32[name]
