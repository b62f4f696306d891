"""threefry2x32 in torch, bit-identical to ``jax.random``.

The channel of this system is defined by its random streams (the §4 fold
registry in ``repro_torch.core.ota``), so the port reproduces JAX's key
schedule exactly rather than using ``torch.Generator``:

* ``PRNGKey(seed)``  — ``jax.random.PRNGKey`` with 64-bit mode off: the
  seed's low 32 bits, ``(0, seed & 0xFFFFFFFF)``;
* ``fold_in(key, data)`` — ``threefry2x32(key, (0, data))``, both words;
* ``split(key, num)`` — ``jax.random.split``;
* ``bits(key, n)`` — ``jax.random.bits(key, (n,), uint32)``;
* ``randint(key, shape, minval, maxval)`` — ``jax.random.randint`` (int32);
* ``uniform`` bit for bit, and ``normal`` to float32 rounding;

each under either value of ``jax_threefry_partitionable``.

Representation. torch covers uint32 only partly, so a uint32 word lives in
an int64 tensor holding a value in [0, 2**32) and every add is masked back
to 32 bits. Keys are such int64 tensors of shape (..., 2); they are a few
words each and stay on the host, where ``fold_in`` hashes them in numpy
uint32 (a tiny torch op costs more to dispatch than to run). ``bits`` draws
on any device and returns an int32 tensor that holds the uint32 bit
pattern: the form the kernels take and reinterpret.

Every function broadcasts over leading key dimensions, so a whole table of
chunk keys draws its streams in one batched call.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# mirrors jax's ``jax_threefry_partitionable`` flag (default True since
# jax 0.5); the port and the reference it is compared with must agree
_PARTITIONABLE = [True]


def threefry_partitionable() -> bool:
    """Which ``bits`` layout is in force (``jax_threefry_partitionable``)."""
    return _PARTITIONABLE[0]


def set_threefry_partitionable(value: bool) -> bool:
    """Select the ``bits`` layout; returns the previous setting so a
    caller can restore it. ``fold_in`` and ``PRNGKey`` do not depend on
    it."""
    prev = _PARTITIONABLE[0]
    _PARTITIONABLE[0] = bool(value)
    return prev


def as_key(key) -> torch.Tensor:
    """A key as an int64 host tensor of uint32 values, shape (..., 2).
    Accepts the port's keys and JAX keys passed across as numpy."""
    if isinstance(key, torch.Tensor):
        return key.to(device="cpu", dtype=torch.int64) & MASK32
    return torch.from_numpy(np.asarray(key).astype(np.int64)) & MASK32


def _rotl(x, r: int):
    """In-place 32-bit rotate left of uint32 values (held in an int64
    tensor, or in a numpy uint32 array, where the mask is a no-op)."""
    hi = x >> (32 - r)
    x <<= r
    x &= MASK32
    x |= hi
    return x


def _broadcast(x0, x1):
    """Writable copies of two operands broadcast to one shape."""
    if isinstance(x0, torch.Tensor):
        x0, x1 = torch.broadcast_tensors(x0, x1)
        return x0.contiguous(), x1.contiguous()
    x0, x1 = np.broadcast_arrays(x0, x1)
    return x0.copy(), x1.copy()


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds), as ``jax._src.prng`` unrolls it.

    The four operands broadcast together and are either uint32-valued
    int64 tensors (the bulk stream draw, on any device) or numpy uint32
    arrays (small host key tables, where each operation costs a fraction
    of a torch dispatch); returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = _broadcast((x0 + ks[0]) & MASK32, (x1 + ks[1]) & MASK32)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            x0 &= MASK32
            _rotl(x1, r)
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x0 &= MASK32
        x1 += ks[(i + 2) % 3]
        x1 += i + 1
        x1 &= MASK32
    return x0, x1


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: (0, low word)."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed with the counter (0, data).
    ``data`` may be an int or an integer array that broadcasts against the
    key's leading dimensions. Computed on the host in numpy uint32."""
    k = as_key(key).numpy().astype(np.uint32)
    d = (np.asarray(data).astype(np.int64) & MASK32).astype(np.uint32)
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], np.zeros_like(d), d)
    return torch.from_numpy(np.stack([y0, y1], axis=-1).astype(np.int64))


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` for every key of a (..., 2) table:
    (..., num, 2). Partitionable layout: new key i is both words of
    threefry2x32(key, (0, i)). Original layout: the 2·num words of
    ``bits(key, 2·num)`` taken in pairs. Computed on the host in numpy
    uint32."""
    k = as_key(key).numpy().astype(np.uint32)
    k0, k1 = k[..., 0, None], k[..., 1, None]
    i = np.arange(num, dtype=np.uint32)
    if threefry_partitionable():
        y0, y1 = threefry2x32(k0, k1, np.zeros_like(i), i)
        out = np.stack([y0, y1], axis=-1)
    else:
        y0, y1 = threefry2x32(k0, k1, i, i + np.uint32(num))
        flat = np.concatenate([y0, y1], axis=-1)
        out = flat.reshape(flat.shape[:-1] + (num, 2))
    return torch.from_numpy(out.astype(np.int64))


def to_bit_pattern(words: torch.Tensor) -> torch.Tensor:
    """uint32-valued int64 -> int32 holding the same bit pattern."""
    words = words - ((words >> 31) << 32)
    return words.to(torch.int32)


def bits(key, n: int, device=None) -> torch.Tensor:
    """``jax.random.bits(key, (n,), jnp.uint32)`` for every key in a
    (..., 2) table, computed on ``device`` (default: the host).

    Returns (..., n) int32 bit patterns. With the partitionable layout
    word i hashes the counter (0, i) and XORs the two outputs. With the
    original layout the counter iota [0, n) (zero-padded to even length)
    is split in halves: word i < h is output 0 of the pair (i, i + h),
    word i >= h output 1 of the pair (i - h, i), with h = ceil(n / 2)."""
    if n >= MASK32:
        raise ValueError(f"bits: n={n} needs the blocked draw of 2**32 words")
    key = as_key(key)
    if device is not None:
        key = key.to(device)
    k0, k1 = key[..., 0, None], key[..., 1, None]
    if key.device.type != "cpu":
        return _bits_range(k0, k1, 0, n, n)
    # on the host, a block of counters at a time, _HOST_BLOCK words (over
    # all keys) per intra-op thread: the hash's ~100 elementwise passes
    # then stay in each core's cache instead of streaming the whole
    # (..., n) words through memory, and each pass is still large enough
    # to be worth splitting over the threads
    lead = tuple(key.shape[:-1])
    out = torch.empty(lead + (n,), dtype=torch.int32)
    step = max(_HOST_BLOCK * torch.get_num_threads()
               // max(math.prod(lead), 1), 1024)
    for j in range(0, n, step):
        out[..., j:j + step] = _bits_range(k0, k1, j, min(j + step, n), n)
    return out


_HOST_BLOCK = 1 << 16     # host draw: words per pass and thread (all keys)


def _bits_range(k0, k1, start: int, stop: int, n: int) -> torch.Tensor:
    """Words [start, stop) of ``bits(key, n)`` (see ``bits``)."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=k0.device)
    if threefry_partitionable():
        y0, y1 = threefry2x32(k0, k1, torch.zeros_like(idx), idx)
        y0 ^= y1
        return to_bit_pattern(y0)
    h = (n + 1) // 2
    first = idx < h
    a = torch.where(first, idx, idx - h)
    b = a + h
    b = torch.where(b < n, b, torch.zeros_like(b))
    y0, y1 = threefry2x32(k0, k1, a, b)
    return to_bit_pattern(torch.where(first, y0, y1))


def _shaped_bits(key, shape, device) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` for every key of a (..., 2) table:
    the words of the flattened shape (JAX counts the counter over the
    row-major flat index), as (..., *shape) uint32-valued int64."""
    shape = tuple(int(d) for d in shape)
    n = 1
    for d in shape:
        n *= d
    words = bits(key, n, device=device).to(torch.int64) & MASK32
    return words.reshape(words.shape[:-1] + shape)


def _fma_f32(a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """float32 a·b + c rounded once, as XLA's CPU backend contracts it
    into a fused multiply-add. The product is exact in float64; the sum
    rounds once there, and where that lands exactly on a float32 midpoint
    the rounding error of the float64 sum (TwoSum) breaks the tie."""
    p = a.double() * b.double()
    c64 = c.double()
    r = p + c64
    bv = r - p
    err = (p - (r - bv)) + (c64 - bv)
    out = r.float()
    side = torch.where(r > out.double(), 1.0, -1.0).to(torch.float32)
    other = torch.nextafter(out, side * float("inf"))
    mid = (out.double() + other.double()) * 0.5
    fix = (r == mid) & (err != 0) & ((err > 0) == (other > out))
    return torch.where(fix, other, out)


_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


def randint(key, shape, minval, maxval, device=None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` with its default
    int32 dtype, bit for bit, for every key of a (..., 2) table: (...,
    *shape) int32. JAX's construction: ``k1, k2 = split(key)``, two words
    per value (``bits(k1)``, ``bits(k2)``) combined modulo the span
    without rejection, all in uint32; minval and maxval (broadcast to
    ``shape``) are clipped to int32 first."""
    shape = tuple(int(d) for d in shape)
    k = split(key, 2)
    return randint_from_words(_shaped_bits(k[..., 0, :], shape, device),
                              _shaped_bits(k[..., 1, :], shape, device),
                              minval, maxval)


def randint_from_words(hi: torch.Tensor, lo: torch.Tensor, minval,
                       maxval) -> torch.Tensor:
    """``randint``'s int32 values from its two words per value: ``hi``
    drawn under the first key of ``split(key)``, ``lo`` under the second
    (any int tensors holding the uint32 bit patterns)."""
    hi = hi.to(torch.int64) & MASK32
    lo = lo.to(torch.int64) & MASK32
    lo_v = torch.as_tensor(minval, dtype=torch.int64, device=hi.device)
    hi_v = torch.as_tensor(maxval, dtype=torch.int64, device=hi.device)
    out_of_range = hi_v > _INT32_MAX
    lo_v = lo_v.clamp(_INT32_MIN, _INT32_MAX)
    hi_v = hi_v.clamp(_INT32_MIN, _INT32_MAX)
    span = (hi_v - lo_v) & MASK32
    span = torch.where(hi_v <= lo_v, torch.ones_like(span), span)
    span = torch.where(out_of_range & (hi_v > lo_v), (span + 1) & MASK32,
                       span)

    def rem(x, y):   # XLA's unsigned remainder: x % 0 is x
        return torch.where(y == 0, x, x % torch.where(y == 0, 1, y))

    mult = rem(torch.full_like(span, 1 << 16), span)
    mult = rem((mult * mult) & MASK32, span)
    offset = ((rem(hi, span) * mult) & MASK32) + rem(lo, span)
    offset = rem(offset & MASK32, span)
    out = (lo_v + offset) & MASK32
    return to_bit_pattern(out)


def uniform_from_words(w: torch.Tensor, minval=0.0,
                       maxval=1.0) -> torch.Tensor:
    """``uniform``'s float32 values from its uint32 words (any int tensor
    holding their bit patterns)."""
    w = w.to(torch.int64) & MASK32
    f = to_bit_pattern((w >> 9) | 0x3F800000).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return f     # f·1 + 0 in one rounding is f, and f >= 0: exact
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, _fma_f32(f, hi - lo, lo))


def uniform(key, shape, minval=0.0, maxval=1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``, bit for
    bit: the top 23 bits of each word become the mantissa of a float in
    [1, 2), which is scaled by (maxval − minval) and shifted by minval in
    one fused multiply-add (as XLA computes it) and clamped below at
    ``minval``. Broadcasts over leading key dimensions."""
    return uniform_from_words(_shaped_bits(key, shape, device), minval,
                              maxval)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


def normal_from_words(w: torch.Tensor) -> torch.Tensor:
    """``normal``'s float32 values from its uint32 words."""
    u = uniform_from_words(w, _NORMAL_LO, 1.0)
    return torch.special.erfinv(u) * torch.tensor(
        _SQRT2_F32, dtype=torch.float32, device=u.device)


def normal(key, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: √2·erfinv(u) of a
    uniform on [nextafter(-1, 0), 1). The uniform is bit-identical to
    JAX's; ``torch.special.erfinv`` and XLA's ``erf_inv`` differ in the
    last place, so the result matches to float32 rounding, not bit for
    bit. Broadcasts over leading key dimensions."""
    return normal_from_words(_shaped_bits(key, shape, device))
