"""The port's planning tools against the JAX package's.

- ``sharding.rules.spec_for`` equal to the reference's for every case of
  ``tests/test_sharding.py`` (its duck-typed ``FakeMesh``), and
  ``tree_specs`` equal leaf by leaf over the parameter axes of all ten
  full LM configs under the three rule sets on the three meshes (16 x 16,
  2 x 16 x 16 and the FL view 4 x 4 x 16): layout tuples against the
  reference's ``PartitionSpec`` entries, exactly;
- ``fl_view``: the reference's device order (its reshape, on device ids)
  is the port's rank order on both production meshes;
- ``launch.steps.param_specs_tree`` and ``cache_specs_tree`` of every
  smoke config equal to the reference's, exactly;
- ``launch.dryrun.active_params`` and ``_pick_microbatches`` equal to
  ``repro.launch.dryrun``'s for every config and input shape, exactly;
- ``launch.op_cost``'s dot FLOPs of a smoke prefill (stablelm, gemma3,
  zamba2) and of a smoke train step (stablelm, and phi3_vision from the
  stub frontend's float embeddings; HOTA step on a 1-device mesh, two
  microbatches, remat "nothing_saveable") against
  ``hlo_cost.analyze`` of the same step lowered by JAX on one CPU device,
  within 0.5 % (they agree exactly). Two differences above 0.5 % are
  named and added back before the comparison: the port's prefill applies
  the head to the last position only (the reference to all S, then takes
  the last: 2·B·(S-1)·d·V more), and the port's Mamba2 SSD computes the
  intra-chunk scores C·Bᵀ once per B/C group where the reference's einsum
  computes them once per head (heads/groups times as many);
- ``kernels.slab``'s ``pad_to_lanes``, ``pad_axis``, ``flat_to_slab``
  and ``slab_to_flat`` equal to the reference's on the same arrays;
- a kernel wrapper on ``meta`` runs its card path's torch ops under the
  trace and records only its kernel's launch (the streaming fold's client
  product a dot, then one K5 launch);
- the dry run's CLI on a small pair writes its JSON (memory, FLOPs, the
  three terms, the dominant one), and a collective or a kernel on
  ``meta`` outside a cost trace raises.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.launch import hlo_cost
from repro.launch import steps as jsteps
from repro.models.model import build_model as jbuild
from repro.models.params import abstract_params as jabstract
from repro.models.params import logical_axes as jlogical_axes
from repro.sharding import rules as jrules
from repro_torch import rng
from repro_torch.common.config import (
    INPUT_SHAPES, FLConfig, InputShape, TrainConfig,
)
from repro_torch.common.tree import tree_leaves
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.hota_step import make_hota_step_parts
from repro_torch.launch import dryrun, op_cost, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.models.params import logical_axes, spec_shapes
from repro_torch.sharding import collectives as col
from repro_torch.sharding import rules
from repro_torch.sharding.mesh_utils import Mesh, fl_view

LM_IDS = [a for a in JARCH_IDS if a != "paper_mlp"]
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 4, 16), ("cluster", "client", "model"))]
RULE_SETS = ["TRAIN_RULES", "SERVE_RULES", "LONGCTX_SERVE_RULES"]
FLOP_RTOL = 5e-3


class FakeMesh:
    """``tests/test_sharding.py``'s duck-typed mesh (names and shape)."""
    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)


def _both(shape, names):
    return FakeMesh(shape, names), Mesh(shape, names, device="meta")


def _jspec(p):
    return tuple(p)


# the cases of tests/test_sharding.py: (axes, rule set, shape, mesh)
SHARDING_CASES = [
    (("embed", "mlp"), "TRAIN_RULES", (2560, 6912), 0),
    (("embed", "kv_heads", "head_dim"), "TRAIN_RULES", (3072, 2, 128), 0),
    (("expert", "embed", "mlp"), "TRAIN_RULES", (16, 4096, 6400), 0),
    (("expert", "embed", "mlp"), "TRAIN_RULES", (8, 6144, 16384), 0),
    (("embed", "mlp"), "TRAIN_RULES", (2560, 6912), 2),
    (("batch", "seq"), "TRAIN_RULES", (256, 4096), 1),
    (("batch", "cache_seq", "kv_heads", "head_dim"), "SERVE_RULES",
     (128, 32768, 8, 128), 0),
]


@pytest.mark.parametrize("case", range(len(SHARDING_CASES)))
def test_spec_for_matches_the_sharding_tests(case):
    axes, rs, shape, m = SHARDING_CASES[case]
    fake, mesh = _both(*MESHES[m])
    want = _jspec(jrules.spec_for(axes, getattr(jrules, rs), shape, fake))
    assert rules.spec_for(axes, getattr(rules, rs), shape, mesh) == want


def _jparam_axes(model):
    specs = {"trunk": model.trunk_specs(), "final": model.final_specs()}
    shapes = jax.tree.map(lambda s: s.shape, specs,
                          is_leaf=lambda x: hasattr(x, "axes"))
    return jlogical_axes(specs), shapes


@pytest.mark.parametrize("arch", LM_IDS)
def test_tree_specs_of_every_full_config(arch):
    jm, pm = jbuild(jget_config(arch)), build_model(get_config(arch))
    jax_axes, jax_shapes = _jparam_axes(jm)
    specs = {"trunk": pm.trunk_specs(), "final": pm.final_specs()}
    axes, shapes = logical_axes(specs), spec_shapes(specs)
    for shape, names in MESHES:
        fake, mesh = _both(shape, names)
        for rs in RULE_SETS:
            want = jax.tree.leaves(
                jrules.tree_specs(jax_axes, jax_shapes, getattr(jrules, rs),
                                  fake),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            got = tree_leaves(rules.tree_specs(axes, shapes,
                                               getattr(rules, rs), mesh))
            assert [_jspec(p) for p in want] == got, (rs, names)
            assert got == tree_leaves(rules.tree_shardings(
                axes, shapes, getattr(rules, rs), mesh))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_fl_view_keeps_the_reference_device_order(multi_pod, monkeypatch):
    from repro.sharding import mesh_utils as jmu

    class IdMesh:
        def __init__(self, devices, names):
            self.devices, self.axis_names = devices, tuple(names)
    monkeypatch.setattr(jmu, "Mesh", IdMesh)
    prod = make_production_mesh(multi_pod=multi_pod)
    ids = np.arange(prod.size).reshape(prod.sizes)
    ref = jmu.fl_view(IdMesh(ids, prod.axis_names), 4)
    view = fl_view(prod, 4)
    assert view.axis_names == ref.axis_names
    assert view.sizes == ref.devices.shape
    for r in (0, 1, 17, 63, prod.size - 1):
        at = Mesh(view.sizes, view.axis_names, rank=r)
        coords = tuple(at.coords[a] for a in view.axis_names)
        assert ref.devices[coords] == r
    with pytest.raises(ValueError, match="does not split"):
        fl_view(prod, 3)


@pytest.mark.parametrize("arch", LM_IDS)
def test_param_and_cache_specs_of_the_smoke_configs(arch):
    jm, pm = jbuild(jget_smoke(arch)), build_model(get_smoke_config(arch))
    fake, mesh = _both(*MESHES[0])
    isp = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    for rs in ("SERVE_RULES", "LONGCTX_SERVE_RULES"):
        want = jsteps.param_specs_tree(jm, getattr(jrules, rs), fake)
        got = steps.param_specs_tree(pm, getattr(rules, rs), mesh)
        assert [_jspec(p) for p in jax.tree.leaves(want, is_leaf=isp)] == \
            tree_leaves(got)
        jcache = jax.eval_shape(lambda: jm.init_cache(4, 64, jnp.bfloat16))
        pcache = pm.init_cache(4, 64, torch.bfloat16, device="meta")
        want = jsteps.cache_specs_tree(jm, jcache, getattr(jrules, rs), fake)
        got = steps.cache_specs_tree(pm, pcache, getattr(rules, rs), mesh)
        assert [_jspec(p) for p in jax.tree.leaves(want, is_leaf=isp)] == \
            tree_leaves(got)


@pytest.fixture(scope="module")
def jdryrun():
    """``repro.launch.dryrun``, imported without its 512-device flag
    reaching this process's JAX (initialized first) or its children."""
    jax.devices()
    prev = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jd
    if prev is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = prev
    return jd


def test_active_params_and_microbatches(jdryrun):
    from repro.common.config import INPUT_SHAPES as JSHAPES
    for arch in LM_IDS:
        assert dryrun.active_params(get_config(arch)) == \
            jdryrun.active_params(jget_config(arch))
        for name, shape in INPUT_SHAPES.items():
            for n_cl in (16, 32):
                assert dryrun._pick_microbatches(
                    get_config(arch), shape, n_cl) == \
                    jdryrun._pick_microbatches(jget_config(arch),
                                               JSHAPES[name], n_cl)


# --------------------------------------------------------------------------
# op_cost against hlo_cost
# --------------------------------------------------------------------------

B, S = 2, 64


def _head_extra(cfg):
    """The reference's prefill applies the head at all S positions."""
    return 2.0 * B * (S - 1) * cfg.d_model * cfg.vocab_size


def _ssd_extra(cfg):
    """The reference's SSD scores once per head, the port's once per B/C
    group: (heads/groups - 1) x the port's 2·B·chunks·G·L·L·N per Mamba2
    layer."""
    if cfg.ssm is None:
        return 0.0
    ssm = cfg.ssm
    chunk = min(ssm.chunk_size, S)
    heads = ssm.expand * cfg.d_model // ssm.head_dim
    per_layer = 2.0 * B * (S // chunk) * ssm.n_groups * chunk * chunk \
        * ssm.d_state
    # every one of n_layers is a Mamba2 layer (ssm, and hybrid's backbone)
    return cfg.n_layers * per_layer * (heads // ssm.n_groups - 1)


@pytest.mark.parametrize("arch", ["stablelm_3b", "gemma3_12b",
                                  "zamba2_1_2b"])
def test_prefill_dot_flops_match_hlo_cost(arch):
    jcfg = jget_smoke(arch).replace(compute_dtype="bfloat16",
                                    remat_policy="none")
    jm = jbuild(jcfg)
    bb = {"trunk": jabstract(jm.trunk_specs(), jnp.bfloat16),
          "final": jabstract(jm.final_specs(), jnp.bfloat16)}
    head = jabstract(jm.head_specs(), jnp.bfloat16)
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    comp = jax.jit(jsteps.make_prefill_step(jm, cache_len=S + 1)).lower(
        bb, head, tok).compile()
    want = hlo_cost.analyze(comp.as_text()).flops

    cfg = get_smoke_config(arch).replace(compute_dtype="bfloat16",
                                         remat_policy="none")
    pm = build_model(cfg)
    b2, h2, _ = steps.abstract_serve_state(pm, InputShape("p", S, B,
                                                          "prefill"))
    _, tot = op_cost.trace(steps.make_prefill_step(pm, cache_len=S + 1), b2,
                           h2, torch.empty(B, S, dtype=torch.int32,
                                           device="meta"))
    got = tot.dot_flops + _head_extra(cfg) + _ssd_extra(cfg)
    assert got == pytest.approx(want, rel=FLOP_RTOL)
    assert tot.kernels == {} and tot.coll_bytes == {}


@pytest.mark.parametrize("arch", ["stablelm_3b", "phi3_vision_4_2b"])
def test_train_step_dot_flops_match_hlo_cost(arch):
    """phi3_vision_4_2b: the vision stub's (B, S, d_model) bfloat16
    embeddings in, as the reference's step takes them."""
    from jax.sharding import Mesh as JMesh
    from repro.common.config import FLConfig as JFL
    from repro.common.config import TrainConfig as JTC
    from repro.core.hota_step import make_hota_train_step as jstep
    over = dict(compute_dtype="bfloat16", remat_policy="nothing_saveable")
    jm = jbuild(jget_smoke(arch).replace(**over))
    vision = jm.cfg.modality == "vision"
    jmesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                  ("cluster", "client", "model"))
    jfl = JFL(n_clients=1, ota_mode="scatter", microbatches=2)
    init_fn, step_fn, _, _ = jstep(jm, jmesh, jfl, JTC(
        lr=3e-4, global_batch=B, seq_len=S, fl=jfl), loss_kind="lm")
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    lab = jax.ShapeDtypeStruct((B, S), jnp.int32)
    tok = (jax.ShapeDtypeStruct((B, S, jm.cfg.d_model), jnp.bfloat16)
           if vision else lab)
    comp = jax.jit(step_fn).lower(jax.eval_shape(init_fn, key), tok, lab,
                                  key).compile()
    want = hlo_cost.analyze(comp.as_text()).flops

    pm = build_model(get_smoke_config(arch).replace(**over))
    mesh = Mesh((1, 1, 1), ("cluster", "client", "model"), device="meta")
    fl = FLConfig(n_clients=1, ota_mode="scatter", microbatches=2)
    parts = make_hota_step_parts(pm, mesh, fl, TrainConfig(
        lr=3e-4, global_batch=B, seq_len=S, fl=fl), loss_kind="lm",
        count_mode="local")
    state = parts.abstract_fn()._replace(step=torch.zeros((),
                                                          dtype=torch.int32))
    t = torch.empty(B, S, dtype=torch.int32, device="meta")
    x = torch.empty(B, S, pm.cfg.d_model, dtype=torch.bfloat16,
                    device="meta") if vision else t
    _, tot = op_cost.trace(
        lambda st, a, b, k: parts.step(st, a, b, k, parts.chan_all, None),
        state, x, t, rng.PRNGKey(0))
    assert tot.dot_flops == pytest.approx(want, rel=FLOP_RTOL)
    # the slab backward's draws and K6 (count mode "local": once per leaf
    # per microbatch's backward) are recorded as one launch each
    assert tot.kernels["ota_mask_count"] == fl.microbatches * len(
        tree_leaves({"t": pm.trunk_specs(), "f": pm.final_specs()}))
    assert tot.kernels["threefry_chunked"] > 0


def test_a_kernel_wrapper_traces_its_card_path_on_meta():
    """On ``meta`` a wrapper runs its card path's torch ops under the
    trace and records only its kernel's launch: the streaming fold's
    (N, P) client product is counted as a dot, then one K5 launch with
    K5's 3·P FLOPs and its operand and result bytes."""
    from repro_torch.kernels.ota_channel import ops
    n_cl, p = 3, 4096
    g = torch.empty(n_cl, 8, p // 8, device="meta")
    words = torch.empty(p, dtype=torch.int32, device="meta")
    (y, m), tot = op_cost.trace(ops.ota_stream_fold_apply, g,
                                torch.ones(n_cl, device="meta"), words,
                                1.0, 0.03, 1.0,
                                live_c=1.0, device="meta")
    assert y.shape == m.shape == (8, p // 8) and y.device.type == "meta"
    assert tot.dot_flops == 2.0 * n_cl * p
    assert tot.kernels == {"ota_mask_weight": 1}
    assert tot.kernel_flops == 3.0 * p
    assert tot.flops == tot.dot_flops + tot.kernel_flops


def test_dryrun_writes_its_json(tmp_path):
    dryrun.main(["--arch", "zamba2-1.2b", "--shape", "long_500k",
                 "--out-dir", str(tmp_path), "--force"])
    dryrun.main(["--arch", "qwen2.5-14b", "--shape", "long_500k",
                 "--out-dir", str(tmp_path)])
    r = json.loads((tmp_path / "zamba2_1_2b__long_500k__pod16x16.json")
                   .read_text())
    assert r["status"] == "ok", r.get("traceback")
    assert r["local_batch"] == 1 and r["n_devices"] == 256
    mem = r["memory"]
    assert mem["total_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["alias_bytes"] > 0          # the cache, updated in place
    assert r["flops_per_device"] > 0
    assert set(r["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                  "dominant"}
    skipped = json.loads((tmp_path / "qwen2_5_14b__long_500k__pod16x16.json")
                         .read_text())
    assert skipped["status"] == "skipped"


@pytest.mark.parametrize("shape", [(1,), (5, 7), (3, 128), (2, 1024),
                                   (8, 3, 129)])
def test_slab_helpers_match_the_reference(shape):
    from repro.kernels import slab as jslab
    from repro_torch.kernels import slab
    x = np.random.default_rng(len(shape)).normal(size=shape).astype(
        np.float32)
    got, n = slab.pad_to_lanes(torch.from_numpy(x))
    want, wn = jslab.pad_to_lanes(jnp.asarray(x))
    assert n == wn and np.array_equal(got.numpy(), np.asarray(want))
    for axis in range(len(shape)):
        assert np.array_equal(
            slab.pad_axis(torch.from_numpy(x), axis, 8).numpy(),
            np.asarray(jslab.pad_axis(jnp.asarray(x), axis, 8)))
    flat = np.arange(2 * 2048, dtype=np.float32).reshape(2, 2048)
    sl = slab.flat_to_slab(torch.from_numpy(flat))
    assert np.array_equal(sl.numpy(), np.asarray(jslab.flat_to_slab(
        jnp.asarray(flat))))
    assert np.array_equal(slab.slab_to_flat(sl).numpy(), flat)
    with pytest.raises(ValueError, match="multiple of 1024"):
        slab.flat_to_slab(torch.zeros(1000))


def test_meta_outside_a_trace_raises():
    mesh = make_production_mesh()
    x = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        col.psum(x, mesh, "data")
    from repro_torch.kernels.ota_channel import ops
    with pytest.raises(ValueError, match="unsupported device meta"):
        ops.bits(rng.PRNGKey(0), 8, device="meta")
