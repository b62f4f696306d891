"""The plain versions of the port's two kernels against the JAX package's
kernels, run as the JAX suite runs them on the CPU: the Pallas kernel in
interpret mode and the jnp reference.

Tolerances: masks are exact except where the uniform lies within one ulp
of p_pass (XLA's and PyTorch's float32 ``erfc`` may differ in the last
place); ĝ and the norms agree to rtol 1e-5, since Box-Muller's log/cos
and the summation order differ between the libraries in the last bits.
The CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.masked_gradnorm.ops import masked_gradnorm as jax_gradnorm
from repro.kernels.ota_channel import ref as jref
from repro.kernels.ota_channel.ops import (
    ota_client_fold_apply as jax_client_fold,
)
from repro_torch.kernels import _build
from repro_torch.kernels.masked_gradnorm.ops import masked_gradnorm
from repro_torch.kernels.ota_channel import ref
from repro_torch.kernels.ota_channel.ops import ota_client_fold_apply
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)


C, N = 3, 2
RTOL = 1e-5


def _case(n, seed):
    r = np.random.default_rng(seed)
    g = r.normal(size=(C, N, n)).astype(np.float32) * 1e-2
    p = r.uniform(0.5, 1.5, size=(C, N)).astype(np.float32)
    bits = r.integers(0, 2 ** 32, size=(C, n), dtype=np.uint32)
    nbits = r.integers(0, 2 ** 32, size=(n,), dtype=np.uint32)
    return g, p, bits, nbits


def _t(x):
    if x.dtype == np.uint32:
        return torch.from_numpy(x.view(np.int32).copy())
    return torch.from_numpy(np.array(x))


# (n, sigma2, ota_on, live, n_eff)
K1_CASES = {
    "ragged": (2 * 1024 + 301, (1.0, 0.5, 2.0), 1.0, None, None),
    "ota_off": (1024, (1.0, 0.5, 2.0), 0.0, None, None),
    "dead_cluster": (1500, (1.0, 1.0, 1.0), 1.0, (1.0, 0.0, 1.0), None),
    "n_eff": (2048 + 64, (1.0, 2.0, 1.0), 1.0, (1.0, 1.0, 0.0), 1.5),
}


def _near_threshold(bits, sigma2, h_th):
    """Entries whose uniform lies within an ulp of p_pass, per cluster."""
    u = bits.astype(np.float32) * np.float32(2.0 ** -32)
    pp = np.asarray(jref.pass_probability(jnp.asarray(sigma2), h_th))
    ulp = np.spacing(pp.astype(np.float32))[:, None]
    return np.abs(u - pp[:, None]) <= ulp


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_plain_matches_jax(case):
    n, sigma2, ota_on, live, n_eff = K1_CASES[case]
    g, p, bits, nbits = _case(n, seed=len(case))
    sig = np.asarray(sigma2, np.float32)
    h_th, z_std = 3.2e-2, 0.7
    jlive = None if live is None else jnp.asarray(live, jnp.float32)
    jn_eff = None if n_eff is None else jnp.float32(n_eff)
    kw = dict(live=jlive, n_eff=jn_eff)
    want_k = np.asarray(jax_client_fold(
        jnp.asarray(g), jnp.asarray(p), jnp.asarray(bits), jnp.asarray(nbits),
        jnp.asarray(sig), h_th, z_std, ota_on, N, impl="pallas",
        interpret=True, **kw))
    want_r = np.asarray(jax_client_fold(
        jnp.asarray(g), jnp.asarray(p), jnp.asarray(bits), jnp.asarray(nbits),
        jnp.asarray(sig), h_th, z_std, ota_on, N, impl="jnp", **kw))
    got = ota_client_fold_apply(
        _t(g), _t(p), _t(bits), _t(nbits), _t(sig),
        torch.tensor(h_th), torch.tensor(z_std), torch.tensor(ota_on), N,
        live=None if live is None else torch.tensor(live),
        n_eff=None if n_eff is None else torch.tensor(n_eff)).numpy()
    assert got.shape == (n,) and got.dtype == np.float32

    # masks: exact away from the threshold
    near = _near_threshold(bits, sig, h_th)
    jm = np.asarray(jref.bits_to_mask(jnp.asarray(bits),
                                      jnp.asarray(sig)[:, None], h_th, ota_on))
    tm = ref.bits_to_mask(_t(bits), _t(sig)[:, None], h_th, ota_on).numpy()
    assert np.array_equal(jm[~near], tm[~near])
    ok = ~near.any(axis=0)
    for want in (want_k, want_r):
        np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=1e-7)
    if ota_on == 0.0:     # error-free: every cluster passes, no noise
        live_v = np.ones(C) if live is None else np.asarray(live)
        wg = np.einsum("cn,cnj->cj", p, g)[live_v > 0.5].sum(0)
        denom = (live_v > 0.5).sum() * (N if n_eff is None else n_eff)
        np.testing.assert_allclose(got, wg / denom, rtol=RTOL, atol=1e-8)


def test_k1_plain_accepts_a_strided_stream_slice():
    """The main path hands K1 a column slice of a wider section stream."""
    g, p, bits, nbits = _case(700, seed=3)
    wide = np.concatenate(
        [np.zeros((C, 64), np.uint32), bits, np.zeros((C, 32), np.uint32)], 1)
    args = (_t(g), _t(p))
    rest = (_t(nbits), torch.ones(C), torch.tensor(0.032), torch.tensor(1.0),
            torch.tensor(1.0), N)
    a = ota_client_fold_apply(*args, _t(wide)[:, 64:764], *rest)
    b = ota_client_fold_apply(*args, _t(bits), *rest)
    assert torch.equal(a, b)


@pytest.mark.parametrize("p_cols", [131328, 1000])
def test_k2_plain_matches_jax_pallas(p_cols):
    r = np.random.default_rng(p_cols)
    g = r.normal(size=(C, N, p_cols)).astype(np.float32)
    m = (r.uniform(size=(C, p_cols)) < 0.8).astype(np.float32)
    got = masked_gradnorm(torch.from_numpy(g), torch.from_numpy(m)).numpy()
    assert got.shape == (C, N)
    for c in range(C):
        want = np.asarray(jax_gradnorm(jnp.asarray(g[c]), jnp.asarray(m[c]),
                                       impl="pallas", interpret=True))
        np.testing.assert_allclose(got[c], want, rtol=RTOL)
    two_d = masked_gradnorm(torch.from_numpy(g[1]), torch.from_numpy(m[1]))
    np.testing.assert_allclose(two_d.numpy(), got[1], rtol=RTOL)


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; anything
    else either launches the kernel (CUDA) or raises."""
    g = torch.empty((C, N, 8), device="meta")
    with pytest.raises(ValueError):
        masked_gradnorm(g, torch.empty((C, 8), device="meta"))
    with pytest.raises(ValueError):
        ota_client_fold_apply(
            g, torch.empty((C, N), device="meta"),
            torch.empty((C, 8), dtype=torch.int32, device="meta"),
            torch.empty((8,), dtype=torch.int32, device="meta"),
            torch.ones(C), 0.032, 1.0, 1.0, N)


def test_kernel_sources_and_build_without_nvcc(monkeypatch, tmp_path):
    names = sorted(s.name for s in _build.sources())
    assert names == ["flash_attention.cu", "flash_hopper_narrow.cu",
                     "flash_hopper_wide.cu", "masked_gradnorm.cu",
                     "ota_aggregate.cu", "ota_aggregate_fused.cu",
                     "ota_channel.cu", "ota_client_fold.cu",
                     "ota_mask_count.cu", "ota_mask_weight.cu",
                     "threefry_stream.cu"]
    assert sorted(h.name for h in _build.headers()) == [
        "flash_hopper.cuh", "hopper.cuh", "ota_estimate.cuh",
        "threefry.cuh"]
    for src in _build.sources():
        text = src.read_text()
        assert "cudaGetLastError" in text
        # every source ports a TPU kernel but the stream draw, which the
        # reference leaves to XLA
        assert ("Replaces the TPU kernel" in text) != (
            src.name == "threefry_stream.cu")
    # K3 and K4 share the per-entry estimate (K7 its Box-Muller draw); K4
    # includes the generator
    for name in ("ota_aggregate.cu", "ota_aggregate_fused.cu",
                 "ota_channel.cu"):
        text = next(s for s in _build.sources() if s.name == name).read_text()
        assert '#include "ota_estimate.cuh"' in text
    fused = next(s for s in _build.sources()
                 if s.name == "ota_aggregate_fused.cu").read_text()
    assert '#include "threefry.cuh"' in fused
    stream = next(s for s in _build.sources()
                  if s.name == "threefry_stream.cu").read_text()
    assert '#include "threefry.cuh"' in stream
    # K8's Hopper kernel sits in flash_hopper.cuh (on hopper.cuh's
    # building blocks), instantiated by the narrow and wide sources
    for name in ("flash_attention.cu", "flash_hopper_narrow.cu",
                 "flash_hopper_wide.cu"):
        text = next(s for s in _build.sources() if s.name == name).read_text()
        assert '#include "flash_hopper.cuh"' in text
    hopper = next(h for h in _build.headers()
                  if h.name == "flash_hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in hopper
    for entry in ("ota_aggregate_f32", "ota_aggregate_fused_f32",
                  "threefry_chunked_u32", "threefry_flat_u32",
                  "flash_attention_bf16", "flash_attention_bf16_hopper",
                  "flash_attention_f32", "ota_mask_count_f32",
                  "ota_channel_f32", "masked_gradnorm_f32",
                  "masked_gradnorm_rowblock_f32"):
        assert entry in _build.SIGNATURES
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
