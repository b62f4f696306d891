"""Plain PyTorch versions of the OTA channel laws (paper eqs. 3, 7-10).

Port of ``repro.kernels.ota_channel.ref``. Bits arrive as int32 tensors
holding the uint32 bit pattern of the threefry streams
(``repro_torch.rng.bits``); they are widened to int64 before any shift or
conversion so the arithmetic is unsigned, and converted to float32 with
round-to-nearest like ``bits.astype(f32)``.

    y(j)  = Σ_l M_l(j) · Σ_n p[l,n] g[l,n](j) + z(j)     (eqs. 3, 8)
    ĝ(j)  = y(j) / (|M(j)| · N_eff), 0 where |M(j)| = 0   (eq. 10, guarded)

These are the CPU path of the kernel wrappers and the yardstick the CUDA
kernels are held against on the card. Two laws draw the eq.-7 mask:
``bits_to_mask`` thresholds the raw uniform word against
P(|H|² ≥ H_th) (the slab engines, K1, K3-K6), and ``ota_channel_ref``
thresholds a Box-Muller gain, h² ≥ H_th (K7, the packed ω̃ gather of
the distributed step).

The chunk-quantized stream (DESIGN.md §4) lives here too, since K4's
plain version draws it: chunk j of a key's stream is ``bits(fold_in(key,
j), CHUNK)`` and a partial last chunk is truncated, so any range of the
stream can be drawn on its own. These draws (``chunk_stream`` and what
calls it, and the flat ``bits``) are the plain versions of the card's
stream kernel (``csrc/threefry_stream.cu``); ``plain_draw_counter`` counts
each call, so a run on the card can show that its paths drew none.
"""
from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.kernels import _build
from repro_torch.kernels.slab import LANE

CHUNK_ROWS = 1024
CHUNK = CHUNK_ROWS * LANE        # the stream quantum (entries per chunk)
TWO_PI = 6.283185307179586
_TWO_PI_F32 = torch.tensor(TWO_PI, dtype=torch.float32)

plain_draw_counter = _build.LaunchCounter("stream_draw_plain")


def _u32(bits: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values in int64."""
    return bits.to(torch.int64) & 0xFFFFFFFF


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def chunk_stream(keys, j0: int, j1: int, device=None) -> torch.Tensor:
    """Chunks j0..j1 (inclusive) of each (..., 2) key's stream, laid end
    to end: (..., (j1 - j0 + 1) * CHUNK) int32 bit patterns."""
    plain_draw_counter.count += 1
    keys = rng.as_key(keys)
    j = torch.arange(j0, j1 + 1, dtype=torch.int64)
    chunk_keys = rng.fold_in(keys.unsqueeze(-2), j)     # (..., n_chunks, 2)
    words = rng.bits(chunk_keys, CHUNK, device=device)  # (..., n_chunks, K)
    return words.reshape(words.shape[:-2] + (-1,))


def chunked_stream(keys, length: int, device=None) -> torch.Tensor:
    """(..., length) words of each key's chunk-quantized stream."""
    n_chunks = -(-length // CHUNK)
    return chunk_stream(keys, 0, n_chunks - 1, device)[..., :length]


def stream_range(keys, start: int, length: int, device=None) -> torch.Tensor:
    """Words [start, start + length) of each key's chunk-quantized stream;
    only the chunks that meet the range are drawn."""
    j0 = start // CHUNK
    j1 = (start + length - 1) // CHUNK
    a = start - j0 * CHUNK
    return chunk_stream(keys, j0, j1, device)[..., a:a + length]


def bits(key, n: int, device=None) -> torch.Tensor:
    """``rng.bits``, counted as a plain draw: (..., n) int32 words of
    ``jax.random.bits(key, (n,))`` for every key of a (..., 2) table."""
    plain_draw_counter.count += 1
    return rng.bits(key, n, device=device)


def bits_to_gaussian(bits: torch.Tensor, sigma2) -> torch.Tensor:
    """Box-Muller on the two u16 halves of each u32 word -> one N(0, σ²)."""
    b = _u32(bits)
    hi = (b >> 16).to(torch.float32)
    lo = (b & 0xFFFF).to(torch.float32)
    # (k + 1) / 65536 keeps u1 in (0, 1], away from log(0)
    u1 = (hi + 1.0) * (1.0 / 65536.0)
    u2 = lo * (1.0 / 65536.0)
    r = torch.sqrt(-2.0 * torch.log(u1))
    h = r * torch.cos(_TWO_PI_F32.to(u2.device) * u2)
    return h * torch.sqrt(_f32(sigma2, h))


def pass_probability(sigma2, h_th) -> torch.Tensor:
    """P(|H|² ≥ H_th) for H ~ N(0, σ²): erfc(√(H_th / 2σ²)) (eq. 7)."""
    sig2 = torch.clamp(torch.as_tensor(sigma2, dtype=torch.float32),
                       min=1e-30)
    h = _f32(h_th, sig2)
    return torch.special.erfc(torch.sqrt(h / (2.0 * sig2)))


def bits_to_mask(bits: torch.Tensor, sigma2, h_th, ota_on=1.0,
                 p_pass=None) -> torch.Tensor:
    """eq. (7) by inverse-CDF thresholding: 1{|H|² ≥ H_th} is exactly
    Bernoulli(p_pass), sampled as ``u < p_pass`` on the raw uniform word.
    ``ota_on < 0.5`` forces all-pass. ``p_pass`` may be given when the
    caller has already computed ``pass_probability(sigma2, h_th)``."""
    u = _u32(bits).to(torch.float32) * (2.0 ** -32)
    if p_pass is None:
        p_pass = pass_probability(sigma2, h_th)
    return torch.logical_or(u < p_pass.to(u.device),
                            _f32(ota_on, u) < 0.5)


def ota_mask_weight_ref(x: torch.Tensor, bits: torch.Tensor, sigma2, h_th,
                        ota_on, w, p_pass=None):
    """Fused mask and weighted apply: (M ∘ (w·x), M) with M as float32, on
    float32 ``x`` and same-shape int32 ``bits``; σ², H_th, ``ota_on`` and
    ``w`` are scalars. ``p_pass`` may be given when the caller has already
    computed ``pass_probability(sigma2, h_th)``."""
    m = bits_to_mask(bits, sigma2, h_th, ota_on, p_pass=p_pass)
    wx = _f32(w, x) * x.to(torch.float32)
    return torch.where(m, wx, torch.zeros_like(wx)), m.to(torch.float32)


def ota_mask_count_ref(x: torch.Tensor, bits_all: torch.Tensor, me: int,
                       sigma2_all, h_th, ota_on, w, live_all=None):
    """K6's plain version: (M_me ∘ (w·x), Σ_l M_l) over float32 ``x`` of n
    entries and the (C, n) int32 words of EVERY cluster's stream, with
    M_l = (u_l < p_pass_l ∨ ota_on < 0.5) ∧ live_l > 0.5 and ``me`` this
    device's cluster. ``sigma2_all`` and ``live_all`` are (C,)."""
    c = bits_all.shape[0]
    sig = torch.as_tensor(sigma2_all, dtype=torch.float32).reshape(c, 1)
    masks = bits_to_mask(bits_all, sig, h_th, ota_on)
    if live_all is not None:
        lv = torch.as_tensor(live_all, dtype=torch.float32).reshape(c, 1)
        masks = torch.logical_and(masks, lv.to(masks.device) > 0.5)
    cnt = torch.sum(masks.to(torch.float32), dim=0)
    wx = _f32(w, x) * x.to(torch.float32)
    out = torch.where(masks[int(me)], wx, torch.zeros_like(wx))
    return out, cnt


def ota_channel_ref(x: torch.Tensor, bits: torch.Tensor, sigma2, h_th,
                    ota_on=1.0):
    """K7's plain version: the Box-Muller gain h ~ N(0, σ²) of each word,
    M = h² ≥ H_th ∨ ota_on < 0.5, and (M ∘ x, M, h) with M in x's dtype;
    ``bits`` has x's shape."""
    h = bits_to_gaussian(bits, sigma2)
    mask = torch.logical_or(h * h >= _f32(h_th, h), _f32(ota_on, h) < 0.5)
    out = torch.where(mask, x, torch.zeros_like(x))
    return out, mask.to(x.dtype), h


def ota_stream_fold_ref(g: torch.Tensor, p_c: torch.Tensor,
                        bits: torch.Tensor, sigma2_c, h_th, ota_on,
                        live_c=None):
    """One cluster's streaming-fold term (M_l ∘ Σ_n p[n]·g[n], M_l) from its
    raw (N, ...) client gradients, its (N,) loss weights and its stream
    slice, before any cross-cluster sum. Folding every cluster in order
    and adding the AWGN and the eq.-10 guard gives the client-folded
    estimate. ``live_c`` ANDs into the mask after the ``ota_on`` gate."""
    wg = torch.einsum("n,n...->...", p_c.to(torch.float32),
                      g.to(torch.float32))
    m = bits_to_mask(bits.reshape(wg.shape), sigma2_c, h_th, ota_on)
    if live_c is not None:
        m = torch.logical_and(m, _f32(live_c, wg) > 0.5)
    return torch.where(m, wg, torch.zeros_like(wg)), m.to(torch.float32)


def ota_aggregate_slab_ref(wg, bits, nbits, sigma2, h_th, noise_std, ota_on,
                           n_clients: int, live=None, n_eff=None,
                           p_pass=None) -> torch.Tensor:
    """eqs. (8)-(10) on (C, ...) weighted gradients: masked sum over the
    cluster axis, AWGN, and the guarded |M|·N estimate. ``live`` (C,)
    ANDs cluster participation into the masks after the ``ota_on`` gate;
    ``n_eff`` replaces the static N in the denominator."""
    c = wg.shape[0]
    bshape = (c,) + (1,) * (wg.dim() - 1)
    sig = torch.as_tensor(sigma2, dtype=torch.float32).reshape(bshape)
    if p_pass is not None:
        p_pass = p_pass.reshape(bshape)
    masks = bits_to_mask(bits, sig, h_th, ota_on, p_pass=p_pass)
    if live is not None:
        lv = torch.as_tensor(live, dtype=torch.float32).reshape(bshape)
        masks = torch.logical_and(masks, lv.to(masks.device) > 0.5)
    wg32 = wg.to(torch.float32)
    y = torch.sum(torch.where(masks, wg32, torch.zeros_like(wg32)), dim=0)
    z = bits_to_gaussian(nbits, 1.0) * _f32(noise_std, y) * _f32(ota_on, y)
    y = y + z
    cnt = torch.sum(masks.to(torch.float32), dim=0)
    if n_eff is None:
        denom = _f32(float(n_clients), y)
    else:
        denom = torch.clamp(_f32(n_eff, y), min=1.0)
    return torch.where(cnt > 0, y / (torch.clamp(cnt, min=1.0) * denom),
                       torch.zeros_like(y))


def ota_aggregate_client_ref(g, p, bits, nbits, sigma2, h_th, noise_std,
                             ota_on, n_clients: int, live=None, n_eff=None,
                             p_pass=None) -> torch.Tensor:
    """Client-folded estimator (eqs. 3 + 8-10) from RAW (C, N, ...) client
    gradients and (C, N) loss weights: Σ_l M_l ∘ (Σ_n p[l,n]·g[l,n]) + z,
    then the guarded estimate. Same laws as ``ota_aggregate_slab_ref``."""
    wg = torch.einsum("cn,cn...->c...", p.to(torch.float32),
                      g.to(torch.float32))
    return ota_aggregate_slab_ref(wg, bits, nbits, sigma2, h_th, noise_std,
                                  ota_on, n_clients, live=live, n_eff=n_eff,
                                  p_pass=p_pass)


def ota_aggregate_fused_ref(wg, keys, sigma2, h_th, noise_std, ota_on,
                            n_clients: int, p_pass=None) -> torch.Tensor:
    """K4's plain version: ``ota_aggregate_slab_ref`` on ONE section's
    (C, n) weighted gradients with the section's streams drawn from its
    (2, 2) keys [gain, AWGN]: cluster l's gain chunk j is
    ``bits(fold_in(fold_in(gain_key, l), j), CHUNK)``, AWGN chunk j is
    ``bits(fold_in(noise_key, j), CHUNK)``, on ``wg``'s device."""
    c, n = wg.shape
    keys = rng.as_key(keys)
    ckeys = rng.fold_in(keys[0].unsqueeze(0),
                        torch.arange(c, dtype=torch.int64))
    bits = chunked_stream(ckeys, n, wg.device)
    nbits = chunked_stream(keys[1], n, wg.device)
    return ota_aggregate_slab_ref(wg, bits, nbits, sigma2, h_th, noise_std,
                                  ota_on, n_clients, p_pass=p_pass)
