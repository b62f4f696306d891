"""The port's attention layers and K8's plain version against the JAX
package, run as the JAX suite runs them on the CPU: the Pallas flash
attention kernel in interpret mode, and its jnp reference.

Tolerances: float32 agrees to rtol/atol 2e-5, the reference's own kernel
test (summation order); bfloat16 to 2e-2, as ``tests/test_kernels.py``
(the output is rounded to bfloat16 after float32 math on both sides).
The CUDA kernel itself runs only on the card (``chip_smoke.py`` phase 14).
"""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import (
    flash_attention as jax_flash, flash_attention_reference as jax_flash_ref,
)
from repro.models import layers as JL
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import layers as L
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


def _qkv(b, s, h, kv, d, seed, s_kv=None):
    r = np.random.default_rng(seed)
    s_kv = s if s_kv is None else s_kv
    return (r.normal(size=(b, s, h, d)).astype(np.float32),
            r.normal(size=(b, s_kv, kv, d)).astype(np.float32),
            r.normal(size=(b, s_kv, kv, d)).astype(np.float32))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


# the four shapes of tests/test_kernels.py::test_flash_attention_matches_ref,
# then two head dims of the port's configs
@pytest.mark.parametrize("b,s,h,kv,d,w", [
    (2, 256, 4, 2, 64, None),
    (1, 512, 4, 4, 128, 128),
    (2, 256, 8, 2, 96, 64),
    (1, 128, 2, 1, 32, None),
    # StableLM-3B's and Gemma-3-12B's head dims (K8's Hopper tilings A, B)
    (1, 256, 4, 2, 80, None),
    (1, 128, 2, 1, 240, 32),
])
def test_k8_plain_matches_jax_kernel_and_reference(b, s, h, kv, d, w):
    q, k, v = _qkv(b, s, h, kv, d, seed=s + d)
    got = ops.flash_attention(_t(q), _t(k), _t(v), window=w).numpy()
    kern = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), window=w, block_q=128,
                                block_kv=128))
    ref = np.asarray(jax_flash_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), window=w))
    np.testing.assert_allclose(got, kern, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("w", [None, 48])
def test_k8_plain_bf16_matches_jax(w):
    b, s, h, kv, d = 1, 256, 4, 2, 64
    q, k, v = _qkv(b, s, h, kv, d, seed=7)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    got = ops.flash_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                              _t(v, torch.bfloat16), window=w)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    kern = np.asarray(jax_flash(jq, jk, jv, window=w, block_q=128,
                                block_kv=128), np.float32)
    ref = np.asarray(jax_flash_ref(jq, jk, jv, window=w), np.float32)
    np.testing.assert_allclose(got, kern, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("s,w", [(77, 5), (1, None), (129, 200)])
def test_k8_plain_ragged_matches_jax_reference(s, w):
    q, k, v = _qkv(2, s, 6, 2, 24, seed=s)
    got = flash_attention_ref(_t(q), _t(k), _t(v), window=w).numpy()
    ref = np.asarray(jax_flash_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), window=w))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_k8_wrapper_checks_shapes():
    q, k, v = (_t(x) for x in _qkv(1, 16, 4, 2, 8, seed=0))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :8], v[:, :8])
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, window=0)


def test_attention_dispatch():
    q, k, v = (_t(x) for x in _qkv(1, 16, 4, 2, 8, seed=1))
    pos = torch.arange(16)
    before = ops.counter.count
    got = L.attention(q, k, v, pos_q=pos, pos_kv=pos, impl="pallas",
                      window=4)
    torch.testing.assert_close(got, flash_attention_ref(q, k, v, window=4))
    assert ops.counter.count == before   # CPU tensors: the plain version
    # the training attention runs and matches the reference's dispatch
    # (folded here: 2 query blocks of 8; with a window it falls back to
    # blocked)
    for impl, w in (("blocked", None), ("blocked", 4), ("folded", None),
                    ("folded", 4)):
        got = L.attention(q, k, v, pos_q=pos, pos_kv=pos, impl=impl,
                          window=w, block_q=8, block_kv=8)
        want = JL.attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                            pos_q=pos.numpy(), pos_kv=pos.numpy(), impl=impl,
                            window=w, block_q=8, block_kv=8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert ops.counter.count == before
    with pytest.raises(ValueError, match="unknown attn_impl"):
        L.attention(q, k, v, pos_q=pos, pos_kv=pos, impl="dense")


@pytest.mark.parametrize("w", [None, 8])
def test_naive_attention_matches_jax(w):
    q, k, v = _qkv(2, 24, 4, 2, 16, seed=3)
    pos = np.arange(24)
    got = L.naive_attention(_t(q), _t(k), _t(v), pos_q=torch.arange(24),
                            pos_kv=torch.arange(24), window=w).numpy()
    ref = np.asarray(JL.naive_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos_q=pos,
        pos_kv=pos, window=w))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_rms_norm_matches_jax():
    r = np.random.default_rng(4)
    x = r.normal(size=(2, 5, 48)).astype(np.float32) * 3
    scale = r.normal(size=(48,)).astype(np.float32) * 0.1
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, 1e-6),
                               (torch.bfloat16, jnp.bfloat16, 1e-2)):
        got = L.rms_norm(_t(x, dtype), _t(scale), 1e-6).float().numpy()
        ref = np.asarray(JL.rms_norm(jnp.asarray(x).astype(jdtype),
                                     jnp.asarray(scale), 1e-6), np.float32)
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("theta", [1e4, 1e5, 1e6])
def test_apply_rope_matches_jax(theta):
    r = np.random.default_rng(5)
    x = r.normal(size=(2, 33, 3, 30)).astype(np.float32)
    pos = np.arange(4000, 4033)
    got = L.apply_rope(_t(x), torch.from_numpy(pos)[None, :], theta).numpy()
    ref = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos)[None, :],
                                   theta))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # decode's (B,) positions, one per request
    bpos = np.array([7, 5000])
    got = L.apply_rope(_t(x[:, :1]), torch.from_numpy(bpos)[:, None],
                       theta).numpy()
    ref = np.asarray(JL.apply_rope(jnp.asarray(x[:, :1]),
                                   jnp.asarray(bpos)[:, None], theta))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_mlp_apply_matches_jax(act):
    r = np.random.default_rng(6)
    d, f = 24, 40
    params = {"w_up": r.normal(size=(d, f)).astype(np.float32) / 5,
              "w_down": r.normal(size=(f, d)).astype(np.float32) / 6}
    if act == "silu":
        params["w_gate"] = r.normal(size=(d, f)).astype(np.float32) / 5
    x = r.normal(size=(2, 7, d)).astype(np.float32)
    got = L.mlp_apply({k: _t(v) for k, v in params.items()}, _t(x),
                      act).numpy()
    ref = np.asarray(JL.mlp_apply({k: jnp.asarray(v)
                                   for k, v in params.items()},
                                  jnp.asarray(x), act))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    if act == "gelu":   # the tanh approximation, not torch's erf default
        h = torch.from_numpy(x @ params["w_up"])
        erf = (torch.nn.functional.gelu(h) @ _t(params["w_down"])).numpy()
        assert np.abs(erf - ref).max() > 1e-4


@pytest.mark.parametrize("window", [8, None])
def test_decode_attention_ring_buffer_eviction(window):
    """A ring cache with window w must ignore evicted (stale) positions,
    and empty slots (pos -1) must never be attended."""
    r = np.random.default_rng(2)
    b, w, kv, d = 2, 8, 2, 16
    k_cache = r.normal(size=(b, w, kv, d)).astype(np.float32)
    v_cache = r.normal(size=(b, w, kv, d)).astype(np.float32)
    # request 0: slots hold 8..15 (pos 16 incoming; slot 0's pos 8 is out
    # of the window: 16 - 8 = 8 is not < 8); request 1: half empty
    pos_tab = np.stack([np.arange(8, 16), np.r_[np.arange(4), -np.ones(4)]]
                       ).astype(np.int32)
    q = r.normal(size=(b, 1, 4, d)).astype(np.float32)
    pos_q = np.array([16, 4], np.int32)
    got = L.decode_attention(_t(q), _t(k_cache), _t(v_cache),
                             pos_q=torch.from_numpy(pos_q),
                             pos_kv=torch.from_numpy(pos_tab),
                             window=window).numpy()
    ref = np.asarray(JL.decode_attention(
        jnp.asarray(q), jnp.asarray(k_cache), jnp.asarray(v_cache),
        pos_q=jnp.asarray(pos_q), pos_kv=jnp.asarray(pos_tab),
        window=window))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    assert np.all(np.isfinite(got))
    # the evicted slot carries no weight: changing it changes nothing
    k2, v2 = k_cache.copy(), v_cache.copy()
    k2[0, 0] += 100.0
    v2[0, 0] += 100.0
    k2[1, 4:] += 100.0
    v2[1, 4:] += 100.0
    moved = L.decode_attention(_t(q), _t(k2), _t(v2),
                               pos_q=torch.from_numpy(pos_q),
                               pos_kv=torch.from_numpy(pos_tab),
                               window=window).numpy()
    if window is not None:
        np.testing.assert_array_equal(moved[0], got[0])
    np.testing.assert_array_equal(moved[1], got[1])


ROOT = pathlib.Path(__file__).resolve().parents[1]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 40
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
