"""The port's package facades against the JAX package's.

- each facade's ``__all__`` (``core``, ``models``, ``optim``, ``data``,
  ``common``, ``sharding``, ``kernels``) equals the reference's (the
  sharding rules, ``fl_view``, ``MeshConfig`` and ``ServeConfig``, once
  left out as XLA tooling, are ported), and every name resolves;
- each facade, and each package entry the port's own modules import
  first, imports in a fresh interpreter without an import cycle, without
  JAX or the JAX package, and without building or loading the kernel
  library or importing ``triton``;
- the names the facades added: ``fgrad_value`` and ``masked_tree_norm``
  against the reference's (rtol 1e-6), ``spec_shapes`` equal, and the
  kernel oracles' reference names (``ota_aggregate_reference``,
  ``masked_gradnorm_reference``, ``flash_attention_reference``) against
  the reference's on the same inputs (float32, rtol 1e-5; the OTA masks
  where both packages' masks agree, as ``tests/test_torch_packed.py``).
"""
import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(HERE, "..", "src"))

FACADES = ["core", "models", "optim", "data", "common", "sharding", "kernels"]
# first imports from a fresh interpreter: the facades, then the modules
# whose packages' facades they run first
ENTRIES = [f"import repro_torch.{p}" for p in FACADES + [
    "configs", "checkpoint", "launch", "experiments"]] + [
    "from repro_torch.kernels.ota_channel import ops",
    "from repro_torch.kernels.flash_attention import ops",
    "from repro_torch.kernels.masked_gradnorm import ops",
    "from repro_torch.models import moe",
    "from repro_torch.models import mamba2",
    "from repro_torch.models import xlstm",
    "from repro_torch.models import hybrid",
    "from repro_torch.models.params import init_params",
    "from repro_torch.core.hota_step import make_hota_train_step",
    "from repro_torch.core import ota",
    "from repro_torch.launch.serve import serve",
    "from repro_torch.launch.train import main",
    "from repro_torch.launch import dryrun",
    "from repro_torch.experiments import quickstart, serve_batched",
    "from repro_torch.convert import lm_params_from_numpy",
    "from repro_torch import rng",
]
CHECK = """
import sys
{entry}
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "repro.", "triton"))
             or m == "repro")
assert not bad, bad
from repro_torch.kernels import _build
assert _build._Loaded.lib is None, "the kernel library was loaded"
print("ok")
"""


@pytest.mark.parametrize("pkg", FACADES)
def test_all_is_the_references_minus_item16(pkg):
    """Every facade exports the reference's names: since the planning
    tools are ported, the port leaves none out."""
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    assert port.__all__ == ref.__all__
    assert [n for n in port.__all__ if not hasattr(port, n)] == []


def test_fresh_interpreters_import_every_entry():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    for i in range(0, len(ENTRIES), 6):    # 6 interpreters at a time
        procs = [(e, subprocess.Popen(
            [sys.executable, "-c", CHECK.format(entry=e)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for e in ENTRIES[i:i + 6]]
        for entry, proc in procs:
            out, _ = proc.communicate(timeout=300)
            assert proc.returncode == 0 and out.strip().endswith("ok"), \
                f"{entry}:\n{out[-3000:]}"


def test_core_names_match_the_reference():
    from repro.core import fedgradnorm as JF
    from repro_torch.core import fgrad_value, masked_tree_norm
    r = np.random.default_rng(0)
    p, n, t = (r.uniform(0.5, 1.5, 6).astype(np.float32) for _ in range(3))
    gbar = np.float32(0.7)
    np.testing.assert_allclose(
        float(fgrad_value(*(torch.from_numpy(a) for a in (p, n)),
                          torch.tensor(gbar), torch.from_numpy(t))),
        float(JF.fgrad_value(jnp.asarray(p), jnp.asarray(n), gbar,
                             jnp.asarray(t))), rtol=1e-6)
    g = {"a": r.normal(size=(3, 5)).astype(np.float32),
         "b": {"c": r.normal(size=(7,)).astype(np.float32)}}
    m = {"a": r.uniform(size=(3, 5)) < 0.5,
         "b": {"c": r.uniform(size=7) < 0.5}}
    want = float(JF.masked_tree_norm(
        {"a": jnp.asarray(g["a"]), "b": {"c": jnp.asarray(g["b"]["c"])}},
        {"a": jnp.asarray(m["a"]), "b": {"c": jnp.asarray(m["b"]["c"])}}))
    got = float(masked_tree_norm(
        {"a": torch.from_numpy(g["a"]), "b": {"c": torch.from_numpy(
            g["b"]["c"])}},
        {"a": torch.from_numpy(m["a"]), "b": {"c": torch.from_numpy(
            m["b"]["c"])}}))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_spec_shapes_match_the_reference():
    import jax
    from repro.configs import get_smoke_config as jcfg
    from repro.models import build_model as jbuild
    from repro.models import spec_shapes as jshapes
    from repro_torch.common.tree import tree_flatten_with_path
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model, spec_shapes
    for arch in ("mixtral_8x22b", "gemma3_12b", "paper_mlp"):
        want = jshapes(jbuild(jcfg(arch)).backbone_specs())
        got = spec_shapes(build_model(get_smoke_config(arch)).backbone_specs())
        flat = [(p, s) for p, s in tree_flatten_with_path(got)]
        assert [s for _, s in flat] == jax.tree.leaves(
            want, is_leaf=lambda x: isinstance(x, tuple))


def test_kernel_reference_names_match_the_reference():
    from repro.kernels import (
        flash_attention_reference as jflash, masked_gradnorm_reference as
        jnorm, ota_aggregate_reference as jagg,
    )
    from repro.kernels.ota_channel import ref as jref
    from repro_torch.kernels import (
        flash_attention_reference, masked_gradnorm_reference, ota_aggregate,
        ota_aggregate_reference,
    )
    from repro_torch.kernels.ota_channel import ref
    r = np.random.default_rng(3)
    c, n_cl, p = 3, 2, 2048
    wg = r.normal(size=(c, p)).astype(np.float32)
    bits = r.integers(0, 2 ** 32, size=(c, p), dtype=np.uint32)
    nbits = r.integers(0, 2 ** 32, size=(p,), dtype=np.uint32)
    sig = np.asarray((0.5, 1.0, 2.0), np.float32)
    i32 = lambda x: torch.from_numpy(x.view(np.int32).copy())   # noqa: E731
    args = (torch.from_numpy(sig), 0.032, 0.7, 1.0, n_cl)
    got = ota_aggregate_reference(torch.from_numpy(wg), i32(bits),
                                  i32(nbits), *args)
    assert torch.equal(got, ota_aggregate(torch.from_numpy(wg), i32(bits),
                                          i32(nbits), *args))
    want = np.asarray(jagg(jnp.asarray(wg), jnp.asarray(bits),
                           jnp.asarray(nbits), jnp.asarray(sig), 0.032, 0.7,
                           1.0, n_cl))
    jm = np.asarray(jref.bits_to_mask(jnp.asarray(bits),
                                      jnp.asarray(sig)[:, None], 0.032))
    tm = ref.bits_to_mask(i32(bits), torch.from_numpy(sig)[:, None],
                          0.032).numpy()
    ok = (jm == tm).all(axis=0)
    assert ok.mean() > 0.99
    np.testing.assert_allclose(got.numpy()[ok], want[ok], rtol=1e-5,
                               atol=1e-6)

    g = r.normal(size=(2, 3, 1000)).astype(np.float32)
    m = (r.uniform(size=(2, 1000)) < 0.8).astype(np.float32)
    got = masked_gradnorm_reference(torch.from_numpy(g), torch.from_numpy(m))
    for ci in range(2):
        np.testing.assert_allclose(
            got[ci].numpy(), np.asarray(jnorm(jnp.asarray(g[ci]),
                                              jnp.asarray(m[ci]))),
            rtol=1e-5)

    q = r.normal(size=(1, 64, 4, 32)).astype(np.float32)
    k, v = (r.normal(size=(1, 64, 2, 32)).astype(np.float32)
            for _ in range(2))
    for w in (None, 16):
        got = flash_attention_reference(*(torch.from_numpy(a)
                                          for a in (q, k, v)), window=w)
        want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), window=w))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
