"""Seeded runs of the port start where the reference's start.

* ``rng.split`` and ``rng.randint`` bit for bit against ``jax.random`` in
  both values of ``jax_threefry_partitionable``, negative ranges, empty
  spans and the full int32 range included;
* ``init_params`` of a key and of a key table, ``HotaSim.init`` and
  ``ScenarioBank.init`` leaf by leaf against the reference's ``init`` of
  the same key: normal leaves to rtol 1e-5 (the uniform is bit-identical;
  ``torch.special.erfinv`` and XLA's ``erf_inv`` differ in the last place,
  up to 5.7e-6 relative), zeros and ones exactly;
* the serve smoke config's weights and prompt against the reference
  ``launch/serve.py``'s keys (``split(PRNGKey(seed), 4)``, ``randint``);
* a narrow 3-round ``run_sweep`` (C=2, N=2, batch 4) against
  ``benchmarks.paper_common.run_sweep`` from the same seed, per-round loss
  and p to rtol 1e-4 (as ``test_torch_sweep``: float32 matmul and reduction
  order differ between XLA and PyTorch, three rounds compound them, and
  the initial weights differ by the erfinv rounding above);
* the stream-draw dispatchers of ``kernels.ota_channel.ops`` on the host
  equal to the plain draws (and counted as plain draws), and the shape
  rule that picks K8's kernel.
"""
import jax
import numpy as np
import pytest
import torch

import benchmarks.paper_common as jpaper_common
import repro.models.model as jmodel
from repro.common.config import (
    FLConfig as JFLConfig, ModelConfig as JModelConfig,
    TrainConfig as JTrainConfig,
)
from repro.configs import get_smoke_config as jget_smoke_config
from repro.core.sim import HotaSim as JHotaSim
from repro.core.sweep import ScenarioBank as JScenarioBank
from repro.data import federated as jfed
from repro.data import radcom as jradcom
from repro.models.model import build_model as jbuild_model
from repro.models.params import init_params as jinit_params
from repro_torch import rng
from repro_torch.common.config import FLConfig, ModelConfig, TrainConfig
from repro_torch.common.tree import tree_leaves
from repro_torch.configs import get_smoke_config
from repro_torch.core.sim import HotaSim
from repro_torch.core.sweep import ScenarioBank
from repro_torch.data.federated import FederatedBatcher
from repro_torch.experiments import paper_common
from repro_torch.kernels.flash_attention import ops as k8
from repro_torch.kernels.masked_gradnorm import ops as k2
from repro_torch.kernels.ota_channel import ops, ref
from repro_torch.launch import serve
from repro_torch.models.model import build_model
from repro_torch.models.params import ParamSpec, init_params
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

DIMS = (32, 64, 128, 64, 32, 16)
C, N = 2, 2
N_CLS = [jradcom.N_CLASSES[jradcom.TASKS[i]] for i in range(N)]
NORMAL_RTOL = 1e-5
SWEEP_RTOL = 1e-4


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


@pytest.fixture
def narrow_mlp(monkeypatch):
    """The JAX package's paper MLP cut to ``DIMS`` for one test."""
    monkeypatch.setattr(jmodel, "PAPER_MLP_DIMS", DIMS)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int64) & 0xFFFFFFFF


def _same_leaves(got_tree, want_tree):
    """Leaf by leaf: exact where the reference's leaf is all zeros or
    ones, else within ``NORMAL_RTOL``."""
    got = [t.numpy() for t in tree_leaves(got_tree)]
    want = [np.asarray(l) for l in jax.tree.leaves(want_tree)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        if np.all(w == 0) or np.all(w == 1):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=NORMAL_RTOL, atol=0)


# --------------------------------------------------------------------------
# split and randint, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("num", [1, 2, 3, 4, 30])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_split_bit_identical(threefry_mode, seed, num):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
    assert np.array_equal(want, _u32(rng.split(rng.PRNGKey(seed), num)))


def test_split_of_a_key_table_is_split_per_key(threefry_mode):
    jkeys = jax.random.split(jax.random.PRNGKey(3), 6)
    got = _u32(rng.split(rng.split(rng.PRNGKey(3), 6).reshape(2, 3, 2), 5))
    for i in range(6):
        want = np.asarray(jax.random.split(jkeys[i], 5))
        assert np.array_equal(got.reshape(6, 5, 2)[i], want)


@pytest.mark.parametrize("shape,lo,hi", [
    ((4, 33), 0, 49152),                  # a prompt of token ids
    ((7,), -5, 5),                        # a range across zero
    ((2, 3, 4), -100000, -3),             # a negative range
    ((1000,), 0, 7),                      # a span that is not a power of 2
    ((64,), 0, 1 << 16),                  # a power-of-2 span
    ((3, 5), -2 ** 31, 2 ** 31 - 1),      # the whole int32 range
    ((10,), 3, 3),                        # an empty span gives minval
    ((10,), 5, 2),                        # maxval < minval gives minval
    ((), 11, 1000),                       # a scalar
])
@pytest.mark.parametrize("seed", [0, 123456789])
def test_randint_bit_identical(threefry_mode, seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape,
                                         lo, hi))
    got = rng.randint(rng.PRNGKey(seed), shape, lo, hi)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert np.array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# init from a key
# --------------------------------------------------------------------------

SPECS = {"w": ParamSpec((12, 9)), "b": ParamSpec((9,), "zeros"),
         "g": ParamSpec((9,), "ones"), "e": ParamSpec((5, 4), "embed"),
         "s": ParamSpec((3, 4, 2), scale=0.5)}


def _jax_specs():
    from repro.models.params import ParamSpec as JParamSpec
    return {k: JParamSpec(s.shape, (None,) * len(s.shape), s.init, s.scale)
            for k, s in SPECS.items()}


def test_init_params_of_a_key_matches_reference(threefry_mode):
    key = jax.random.PRNGKey(42)
    want = jinit_params(_jax_specs(), key)
    got = init_params(SPECS, rng.PRNGKey(42))
    _same_leaves(got, want)


def test_init_params_of_a_key_table_is_the_reference_vmap(threefry_mode):
    keys = jax.random.split(jax.random.PRNGKey(9), C * N).reshape(C, N, -1)
    want = jax.vmap(jax.vmap(lambda k: jinit_params(_jax_specs(), k)))(keys)
    got = init_params(SPECS, rng.split(rng.PRNGKey(9), C * N).reshape(
        C, N, 2))
    _same_leaves(got, want)


def _sims(fl_kw=None):
    fl_kw = fl_kw or {}
    jsim = JHotaSim(jmodel.Model(JModelConfig(family="mlp")),
                    JFLConfig(n_clusters=C, n_clients=N, **fl_kw),
                    JTrainConfig(lr=3e-4), N_CLS)
    sim = HotaSim(build_model(ModelConfig(family="mlp"), DIMS),
                  FLConfig(n_clusters=C, n_clients=N, **fl_kw),
                  TrainConfig(lr=3e-4), N_CLS, device="cpu")
    return jsim, sim


@pytest.mark.parametrize("seed", [0, 5])
def test_hotasim_init_matches_reference(narrow_mlp, threefry_mode, seed):
    jsim, sim = _sims()
    jstate = jsim.init(jax.random.PRNGKey(seed))
    state = sim.init(rng.PRNGKey(seed))
    _same_leaves(state.omega, jstate.omega)
    _same_leaves(state.heads, jstate.heads)
    np.testing.assert_array_equal(state.p.numpy(), np.asarray(jstate.p))
    np.testing.assert_array_equal(state.ps_opt.mu.numpy(),
                                  np.asarray(jstate.ps_opt.mu))
    np.testing.assert_array_equal(state.f0.numpy(), np.asarray(jstate.f0))


def test_bank_init_repeats_the_sim_init(narrow_mlp):
    jsim, sim = _sims()
    specs = [dict(weighting="equal"), dict(sigma2=(0.5, 1.0))]
    jstates = JScenarioBank(jsim, specs).init(jax.random.PRNGKey(1))
    states = ScenarioBank(sim, specs).init(rng.PRNGKey(1))
    _same_leaves(states.omega, jstates.omega)
    _same_leaves(states.heads, jstates.heads)


# --------------------------------------------------------------------------
# serving: weights and prompt from the reference's keys
# --------------------------------------------------------------------------

def test_serve_weights_and_prompt_match_reference_keys():
    arch, seed, batch, length = "starcoder2_3b", 3, 2, 9
    jm = jbuild_model(jget_smoke_config(arch))
    k_trunk, k_final, k_head, k_prompt = jax.random.split(
        jax.random.PRNGKey(seed), 4)
    cfg = get_smoke_config(arch)
    backbone, head = serve.init_weights(serve.serving_model(cfg), seed, "cpu")
    _same_leaves(backbone["trunk"], jinit_params(jm.trunk_specs(), k_trunk))
    _same_leaves(backbone["final"], jinit_params(jm.final_specs(), k_final))
    _same_leaves(head, jinit_params(jm.head_specs(), k_head))
    want = np.asarray(jax.random.randint(k_prompt, (batch, length), 0,
                                         cfg.vocab_size))
    got = serve.draw_prompt(cfg, batch, length, seed)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# a narrow run_sweep against the reference's, from the same seed
# --------------------------------------------------------------------------

def _data(fl_c, fl_n, seed):
    data = jradcom.make_radcom_dataset(
        jradcom.RadComConfig(n_points=600, feature_dim=DIMS[0]))
    return jradcom.client_partition(data, fl_c, fl_n, seed=seed)


def test_run_sweep_matches_reference(narrow_mlp, monkeypatch, tmp_path):
    def jax_setup(fl, batch=24, seed=0):
        sim = JHotaSim(jmodel.Model(JModelConfig(family="mlp")), fl,
                       JTrainConfig(lr=3e-4), N_CLS)
        parts = _data(fl.n_clusters, fl.n_clients, seed)
        return sim, jfed.FederatedBatcher(parts, batch, seed=seed + 1)

    def port_setup(fl, batch=24, seed=0, device="cuda"):
        sim = HotaSim(build_model(ModelConfig(family="mlp"), DIMS), fl,
                      TrainConfig(lr=3e-4), N_CLS, device=device)
        parts = _data(fl.n_clusters, fl.n_clients, seed)
        return sim, FederatedBatcher(parts, batch, seed=seed + 1)

    monkeypatch.setattr(jpaper_common, "paper_mlp_setup", jax_setup)
    monkeypatch.setattr(jpaper_common, "RESULTS_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(paper_common, "paper_mlp_setup", port_setup)
    exps = {"fgn": dict(weighting="fedgradnorm", sigma2=[0.5, 1.0]),
            "equal": dict(weighting="equal", sigma2=[0.5, 1.0])}
    kw = dict(steps=3, n_clusters=C, n_clients=N, batch=4, seed=2,
              log_every=10, tune=False)
    want = jpaper_common.run_sweep(exps, sharded=False, **kw)
    got = paper_common.run_sweep(exps, device="cpu",
                                 results_dir=str(tmp_path / "port"), **kw)
    for name in exps:
        for field in ("loss_cluster0", "loss_mean_tasks", "p_cluster0",
                      "p_mean"):
            np.testing.assert_allclose(
                np.asarray(got[name][field]), np.asarray(want[name][field]),
                rtol=SWEEP_RTOL, err_msg=f"{name} {field}")


# --------------------------------------------------------------------------
# the stream draws on the host, and K8's kernel rule
# --------------------------------------------------------------------------

def test_draw_dispatchers_on_the_host_are_the_plain_draws(threefry_mode):
    keys = rng.fold_in(rng.PRNGKey(5).unsqueeze(0), torch.arange(3))
    chunk = ref.CHUNK
    want = (ref.chunk_stream(keys, 1, 2), ref.chunked_stream(keys, chunk + 7),
            ref.chunk_stream(keys, 0, 1)[:, chunk - 3:chunk + 7],
            rng.bits(keys, 1001))
    for device in (None, "cpu"):
        before = ref.plain_draw_counter.count
        got = (ops.chunk_stream(keys, 1, 2, device),
               ops.chunked_stream(keys, chunk + 7, device),
               ops.stream_range(keys, chunk - 3, 10, device),
               ops.bits(keys, 1001, device))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert ref.plain_draw_counter.count - before == 4
    launches = (ops.stream_counter.count, ops.bits_counter.count)
    with pytest.raises(ValueError):
        ops.chunked_stream(keys, 10, "meta")
    assert (ops.stream_counter.count, ops.bits_counter.count) == launches


@pytest.mark.parametrize("dtype,d,kernel", [
    *[(torch.bfloat16, d, "hopper") for d in (64, 80, 96, 128, 240, 256)],
    *[(torch.bfloat16, d, "mma_sync") for d in (20, 24, 30, 32, 48, 72)],
    (torch.float32, 128, "fma"), (torch.float32, 96, "fma"),
    (torch.float16, 128, None)])
def test_k8_kernel_rule(dtype, d, kernel):
    """bf16 at a multiple of 16 from 64 to 256 takes the Hopper kernel,
    other bf16 head dims mma.sync, float32 the FMA kernel; float16 is
    refused."""
    if kernel is None:
        with pytest.raises(ValueError):
            k8.kernel_for(dtype, d)
    else:
        assert k8.kernel_for(dtype, d) == kernel


@pytest.mark.parametrize("d,kernel,match", [
    (72, "hopper", "does not take"),      # stays on mma_sync
    (80, "fma", "does not take"),         # bf16 is never the FMA kernel's
    (272, None, "not supported"),         # past MAX_HEAD_DIM
])
def test_k8_launch_refusals(d, kernel, match):
    """``launch`` refuses a kernel the rule does not give that shape (the
    mma.sync design aside, which it runs at a Hopper shape for timing) and
    head dims past 256, before touching a device."""
    q = torch.zeros((1, 4, 2, d), dtype=torch.bfloat16)
    kv = torch.zeros((1, 4, 1, d), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        k8.launch(q, kv, kv, torch.empty_like(q), None, kernel=kernel)


@pytest.mark.parametrize("arch", [
    "starcoder2_3b", "stablelm_3b", "qwen2_5_14b", "gemma3_12b",
    "mixtral_8x22b", "phi3_5_moe_42b", "musicgen_medium",
    "phi3_vision_4_2b", "zamba2_1_2b"])
def test_lm_configs_take_the_hopper_kernel(arch):
    """Every full LM config the port serves prefills on K8's Hopper kernel
    in bf16 (Zamba2's attention is its shared block's: 32 heads of 64)."""
    from repro_torch.configs import get_config
    from repro_torch.models.hybrid import _shared_attn_cfg
    cfg = get_config(arch)
    if cfg.family == "hybrid":
        cfg = _shared_attn_cfg(cfg)
        assert (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim) == (
            32, 32, 64)
    assert cfg.compute_dtype == "bfloat16"
    assert k8.kernel_for(torch.bfloat16, cfg.resolved_head_dim) == "hopper"


def test_k2_split_rule():
    assert k2.splits(30, 131328, 132) == 18
    assert k2.splits(1, 1, 132) == 1
    assert k2.splits(1, 10 * k2.MIN_SEGMENT, 132) == 10
    for rows, p in ((30, 131328), (3, 4099), (600, 10 ** 6)):
        s = k2.splits(rows, p, 132)
        assert s >= 1 and (s == 1 or p // s >= k2.MIN_SEGMENT)
