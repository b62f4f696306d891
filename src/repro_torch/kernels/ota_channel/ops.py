"""Wrappers of the OTA channel kernels: K1 (client fold), K3 and K4 (slab
estimate from supplied or in-kernel stream words), K5 (mask and
weighted apply), K6 (mask, weighted apply and |M| count over every
cluster's stream) and K7 (gain-threshold mask and apply).

Ports of ``repro.kernels.ota_channel.ops``:

* ``ota_client_fold_apply``: one leaf's PS estimate ĝ from its RAW (C, N,
  *shape) client gradients, the (C, N) loss weights and the leaf's slices
  of the gain and noise bit streams (``csrc/ota_client_fold.cu``);
* ``ota_mask_weight_apply``: (M ∘ (w·x), M) for one leaf and one stream
  slice (``csrc/ota_mask_weight.cu``);
* ``ota_stream_fold_apply``: one (leaf, cluster) term of the streaming
  engines, the (N,) client weights folded with one torch product and then
  ``ota_mask_weight_apply``;
* ``ota_aggregate``: the (P,) estimate of a whole (C, P) weighted slab from
  its supplied gain and noise words, one K3 launch
  (``csrc/ota_aggregate.cu``);
* ``ota_mask_count_apply``: (M_me ∘ (w·x), Σ_l M_l) for one leaf from
  every cluster's stream slice (``csrc/ota_mask_count.cu``), the
  distributed step's collective-free count;
* ``_ota_channel_impl``, ``ota_channel`` and ``ota_channel_reference``:
  (M ∘ x, M) under the Box-Muller gain law on a flat slab
  (``csrc/ota_channel.cu``), the packed ω̃ gather of the distributed step;
* ``_ota_aggregate_fused_impl``: the packed engine's per-section schedule,
  one launch per non-empty section: K4 (``csrc/ota_aggregate_fused.cu``)
  draws the section's words in the kernel from its two keys, or, with the
  words supplied, K3 reads them;
* ``chunk_stream``, ``chunked_stream``, ``stream_range`` and ``bits``: the
  channel's threefry words (chunk-quantized or flat), drawn on the card by
  one launch of ``csrc/threefry_stream.cu`` for a whole key table. Every
  engine draws its words through these.

For CPU tensors (or a draw on the host) each runs its plain version
(``ref``); for CUDA tensors it launches its kernel or raises. A running
cost trace records each launch (``common.cost_trace``; K1 and K5 with
the float operations their bounds count, the byte-bound others with
none); on ``meta`` tensors inside one (the dry run) a wrapper runs its
card path's torch ops and records its kernel without running it, and
outside one they raise. The packed engine's ``_ota_aggregate_fused_impl``
takes the card or the CPU only.
"""
from __future__ import annotations

import torch

from repro_torch import rng
from repro_torch.common.cost_trace import kernel_launch
from repro_torch.kernels import _build
from repro_torch.kernels.ota_channel.ref import (
    CHUNK, ota_aggregate_client_ref, ota_aggregate_fused_ref,
    ota_aggregate_slab_ref, ota_channel_ref, ota_mask_count_ref,
    ota_mask_weight_ref, ota_stream_fold_ref, pass_probability,
)
from repro_torch.kernels.ota_channel.ref import bits as ref_bits
from repro_torch.kernels.ota_channel.ref import chunk_stream as ref_chunk_stream
from repro_torch.kernels.ota_channel.ref import (
    chunked_stream as ref_chunked_stream,
)
from repro_torch.kernels.ota_channel.ref import stream_range as ref_stream_range
from repro_torch.kernels.slab import LANE, slab_rows

client_fold_counter = _build.LaunchCounter("ota_client_fold")
mask_weight_counter = _build.LaunchCounter("ota_mask_weight")
aggregate_counter = _build.LaunchCounter("ota_aggregate")
fused_counter = _build.LaunchCounter("ota_aggregate_fused")
mask_count_counter = _build.LaunchCounter("ota_mask_count")
channel_counter = _build.LaunchCounter("ota_channel")
stream_counter = _build.LaunchCounter("threefry_chunked")
bits_counter = _build.LaunchCounter("threefry_flat")

BLOCK = 256
BLOCKS_PER_SM = 8
_SMEM_LIMIT = 48 * 1024


def _scalar(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device).reshape(1)


def client_params(p, sigma2, h_th, noise_std, ota_on, n_clusters: int,
                  n_clients: int, live=None, n_eff=None, device=None):
    """The kernel's params row, laid out as the reference's (1, C(N+2)+4)
    block: [σ²_l, p[l,n], H_th, z_std, ota_on, live_l, N_eff]."""
    c, n = n_clusters, n_clients
    live_v = (torch.ones(c, dtype=torch.float32, device=device)
              if live is None else
              torch.as_tensor(live, dtype=torch.float32,
                              device=device).reshape(c))
    n_eff_v = (torch.full((1,), float(n), dtype=torch.float32, device=device)
               if n_eff is None else
               torch.clamp(_scalar(n_eff, device), min=1.0))
    return torch.cat([
        torch.as_tensor(sigma2, dtype=torch.float32, device=device).reshape(c),
        torch.as_tensor(p, dtype=torch.float32, device=device).reshape(c * n),
        _scalar(h_th, device), _scalar(noise_std, device),
        _scalar(ota_on, device), live_v, n_eff_v])


def launch(flat: torch.Tensor, bits: torch.Tensor, nbits: torch.Tensor,
           params: torch.Tensor, p_pass: torch.Tensor,
           out: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on prepared CUDA operands: ``flat`` (C, N, n)
    float32, ``bits`` (C, n) int32 with unit stride along n, ``nbits``
    (n,) int32, the ``client_params`` row, ``p_pass`` (C,) and ``out``
    (n,) float32. Checks what the kernel assumes and raises otherwise."""
    n_clusters, n_clients, n = flat.shape
    dev = flat.device
    if flat.dtype != torch.float32 or not flat.is_contiguous():
        raise ValueError("g must be a contiguous float32 CUDA tensor")
    if (bits.dtype != torch.int32 or bits.device != dev
            or tuple(bits.shape) != (n_clusters, n)
            or (n > 1 and bits.stride(1) != 1)):
        raise ValueError("bits must be a (C, n) int32 CUDA tensor with unit "
                         "stride along the entries")
    if (nbits.dtype != torch.int32 or nbits.device != dev
            or tuple(nbits.shape) != (n,) or not nbits.is_contiguous()):
        raise ValueError("nbits must be a contiguous (n,) int32 CUDA tensor")
    for name, t, size in (("params", params,
                           n_clusters * (n_clients + 2) + 4),
                          ("p_pass", p_pass, n_clusters), ("out", out, n)):
        if (t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous() or t.numel() != size):
            raise ValueError(f"{name} must be a contiguous float32 CUDA "
                             f"tensor of {size} elements")
    smem = 4 * (n_clusters * (n_clients + 3) + 4)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"C={n_clusters}, N={n_clients} needs {smem} bytes "
                         f"of shared memory for the params row")
    if n == 0 or not kernel_launch(
            "ota_client_fold", n * (2 * n_clusters * n_clients
                                    + 4 * n_clusters + 30),
            (flat, bits, nbits, params, p_pass), (out,)):
        return out
    grid = max(1, min(-(-n // BLOCK), BLOCKS_PER_SM * _build.sm_count(dev)))
    err = _build.library().ota_client_fold_f32(
        flat.data_ptr(), bits.data_ptr(), bits.stride(0), nbits.data_ptr(),
        params.data_ptr(), p_pass.data_ptr(), out.data_ptr(), n, n_clusters,
        n_clients, grid, BLOCK, _build.current_stream_handle(dev))
    _build.check(err, "ota_client_fold")
    client_fold_counter.count += 1
    return out


def ota_client_fold_apply(g: torch.Tensor, p: torch.Tensor,
                          bits: torch.Tensor, nbits: torch.Tensor, sigma2,
                          h_th, noise_std, ota_on, n_clients: int,
                          live=None, n_eff=None) -> torch.Tensor:
    """ĝ = guard(Σ_l M_l ∘ (Σ_n p[l,n]·g[l,n]) + z) for ONE leaf.

    ``g``: (C, N, *shape) float32; ``bits``: (C, n) int32 bit patterns
    (a column slice of a wider stream is fine: rows may be strided);
    ``nbits``: (n,) int32. Returns the (*shape,) float32 estimate.
    ``live`` (C,) / ``n_eff`` () inject partial participation; None is the
    full-participation identity (live = 1, N_eff = N)."""
    n_clusters, n_cl = g.shape[:2]
    if n_cl != n_clients:
        raise ValueError(f"g has {n_cl} clients, expected {n_clients}")
    shape = g.shape[2:]
    n = g.numel() // (n_clusters * n_clients)
    if tuple(bits.shape) != (n_clusters, n) or tuple(nbits.shape) != (n,):
        raise ValueError(f"bits {tuple(bits.shape)} / nbits "
                         f"{tuple(nbits.shape)} do not match a leaf of {n} "
                         f"entries over {n_clusters} clusters")
    flat = g.reshape(n_clusters, n_clients, n)
    if g.device.type == "cpu":
        out = ota_aggregate_client_ref(flat, p, bits, nbits, sigma2, h_th,
                                       noise_std, ota_on, n_clients,
                                       live=live, n_eff=n_eff)
        return out.reshape(shape)
    if g.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {g.device}")
    dev = g.device
    params = client_params(p, sigma2, h_th, noise_std, ota_on, n_clusters,
                           n_clients, live=live, n_eff=n_eff, device=dev)
    # the same torch call the plain version makes, on the same device
    p_pass = pass_probability(params[:n_clusters],
                              params[n_clusters * (n_clients + 1)])
    out = torch.empty(n, dtype=torch.float32, device=dev)
    return launch(flat, bits, nbits, params, p_pass, out).reshape(shape)


def mask_weight_params(sigma2, h_th, ota_on, w, device=None) -> torch.Tensor:
    """K5's params row, laid out as the reference's (1, 4) block:
    [σ², H_th, ota_on, w]."""
    return torch.cat([_scalar(v, device) for v in (sigma2, h_th, ota_on, w)])


def launch_mask_weight(x: torch.Tensor, bits: torch.Tensor,
                       params: torch.Tensor, p_pass: torch.Tensor,
                       out: torch.Tensor, mask: torch.Tensor):
    """Launch K5 on prepared CUDA operands: ``x`` (rows, n) contiguous
    float32, ``bits`` (rows, n) int32 with unit stride along n (rows may
    be strided), the ``mask_weight_params`` row, ``p_pass`` (1,), and
    ``out``/``mask`` (rows, n) float32. Checks what the kernel assumes
    and raises otherwise."""
    rows, n = x.shape
    dev = x.device
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 CUDA tensor")
    if (bits.dtype != torch.int32 or bits.device != dev
            or tuple(bits.shape) != (rows, n)
            or (n > 1 and bits.stride(1) != 1)):
        raise ValueError("bits must be a (rows, n) int32 CUDA tensor with "
                         "unit stride along the entries")
    for name, t, size in (("params", params, 4), ("p_pass", p_pass, 1),
                          ("out", out, rows * n), ("mask", mask, rows * n)):
        if (t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous() or t.numel() != size):
            raise ValueError(f"{name} must be a contiguous float32 CUDA "
                             f"tensor of {size} elements")
    if not 0 < rows <= 65535:
        raise ValueError(f"{rows} rows: the kernel takes 1 to 65535")
    if n == 0 or not kernel_launch("ota_mask_weight", 3 * rows * n,
                                   (x, bits, params, p_pass), (out, mask)):
        return out, mask
    grid = max(1, min(-(-n // BLOCK),
                      -(-BLOCKS_PER_SM * _build.sm_count(dev) // rows)))
    err = _build.library().ota_mask_weight_f32(
        x.data_ptr(), bits.data_ptr(), bits.stride(0), params.data_ptr(),
        p_pass.data_ptr(), out.data_ptr(), mask.data_ptr(), n, rows, grid,
        BLOCK, _build.current_stream_handle(dev))
    _build.check(err, "ota_mask_weight")
    mask_weight_counter.count += 1
    return out, mask


def ota_mask_weight_apply(x: torch.Tensor, bits: torch.Tensor, sigma2, h_th,
                          ota_on, weight):
    """(M ∘ (w·x), M) shaped like ``x``, both float32, for ONE leaf.

    ``bits`` holds the leaf's int32 stream words, one per entry of ``x``:
    (n,) for a leaf of n entries, or (rows, n) for a 2-D ``x`` (a column
    slice of a wider stream is fine: rows may be strided). σ², H_th,
    ``ota_on`` and ``weight`` are scalars."""
    rows_shape = (1, x.numel()) if x.dim() != 2 else tuple(x.shape)
    b = bits.reshape(rows_shape) if bits.dim() == 1 else bits
    if tuple(b.shape) != rows_shape:
        raise ValueError(f"bits {tuple(bits.shape)} do not match x "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return ota_mask_weight_ref(x, b.reshape(x.shape), sigma2, h_th,
                                   ota_on, weight)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {x.device}")
    dev = x.device
    params = mask_weight_params(sigma2, h_th, ota_on, weight, device=dev)
    # the same torch call the plain version makes, on the same device
    p_pass = pass_probability(params[0], params[1]).reshape(1)
    flat = x.to(torch.float32).contiguous().reshape(rows_shape)
    out = torch.empty(rows_shape, dtype=torch.float32, device=dev)
    mask = torch.empty(rows_shape, dtype=torch.float32, device=dev)
    launch_mask_weight(flat, b, params, p_pass, out, mask)
    return out.reshape(x.shape), mask.reshape(x.shape)


def ota_stream_fold_apply(g: torch.Tensor, p_c: torch.Tensor,
                          bits: torch.Tensor, sigma2_c, h_th, ota_on,
                          live_c=None):
    """One (leaf, cluster) term of the streaming engines: (M ∘ (Σ_n
    p[n]·g[n]), M) shaped like ``g[0]``, both float32, from the cluster's
    raw (N, *shape) client gradients, its (N,) loss weights and its (n,)
    stream slice. The client fold is one torch product (the reference
    computes it outside its kernel too); K5 applies the mask with w = 1;
    both outputs are then scaled by the {0, 1} ``live_c`` flag, which
    equals ANDing it into the mask."""
    n_cl = g.shape[0]
    shape = g.shape[1:]
    flat = g.reshape(n_cl, -1)
    if tuple(bits.shape) != (flat.shape[1],):
        raise ValueError(f"bits {tuple(bits.shape)} do not match a leaf of "
                         f"{flat.shape[1]} entries")
    if g.device.type == "cpu":
        y, cnt = ota_stream_fold_ref(flat, p_c, bits, sigma2_c, h_th,
                                     ota_on, live_c=live_c)
        return y.reshape(shape), cnt.reshape(shape)
    if g.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {g.device}")
    wg = torch.matmul(p_c.to(torch.float32).reshape(n_cl),
                      flat.to(torch.float32))
    out, mask = ota_mask_weight_apply(wg, bits, sigma2_c, h_th, ota_on, 1.0)
    if live_c is not None:
        lv = (torch.as_tensor(live_c, dtype=torch.float32, device=g.device)
              > 0.5).to(torch.float32)
        out, mask = out * lv, mask * lv
    return out.reshape(shape), mask.reshape(shape)


# --------------------------------------------------------------------------
# K3 and K4: the packed slab estimate
# --------------------------------------------------------------------------

def aggregate_params(sigma2, h_th, noise_std, ota_on, n_clusters: int,
                     device=None) -> torch.Tensor:
    """K3's and K4's params row, laid out as the reference's (1, C+3)
    block: [σ²_0..σ²_{C-1}, H_th, z_std, ota_on]."""
    return torch.cat([
        torch.as_tensor(sigma2, dtype=torch.float32,
                        device=device).reshape(n_clusters),
        _scalar(h_th, device), _scalar(noise_std, device),
        _scalar(ota_on, device)])


def _check_rows(name: str, t: torch.Tensor, shape, dtype, dev) -> None:
    """Raise unless ``t`` is a ``shape`` CUDA tensor of ``dtype`` on
    ``dev`` whose entries (the last axis) have unit stride; rows may sit
    at any stride (a column slice of a wider slab)."""
    if (t.dtype != dtype or t.device != dev or tuple(t.shape) != shape
            or (shape[-1] > 1 and t.stride(-1) != 1)):
        raise ValueError(f"{name} must be a {shape} {dtype} CUDA tensor "
                         f"with unit stride along the entries")


def _check_aggregate_operands(wg, params, p_pass, out) -> None:
    n_clusters, n = wg.shape
    _check_rows("wg", wg, (n_clusters, n), torch.float32, wg.device)
    for name, t, size in (("params", params, n_clusters + 3),
                          ("p_pass", p_pass, n_clusters), ("out", out, n)):
        if (t.dtype != torch.float32 or t.device != wg.device
                or not t.is_contiguous() or t.numel() != size):
            raise ValueError(f"{name} must be a contiguous float32 CUDA "
                             f"tensor of {size} elements")


def launch_aggregate(wg: torch.Tensor, bits: torch.Tensor,
                     nbits: torch.Tensor, params: torch.Tensor,
                     p_pass: torch.Tensor, n_clients: int,
                     out: torch.Tensor) -> torch.Tensor:
    """Launch K3 on prepared CUDA operands: ``wg`` (C, n) float32 and
    ``bits`` (C, n) int32, each with unit stride along n (rows may be
    strided), ``nbits`` (n,) int32, the ``aggregate_params`` row, ``p_pass``
    (C,) and ``out`` (n,) float32. Checks what the kernel assumes and
    raises otherwise."""
    n_clusters, n = wg.shape
    dev = wg.device
    _check_aggregate_operands(wg, params, p_pass, out)
    _check_rows("bits", bits, (n_clusters, n), torch.int32, dev)
    _check_rows("nbits", nbits, (n,), torch.int32, dev)
    if n == 0 or not kernel_launch("ota_aggregate", 0.0,
                                   (wg, bits, nbits, params, p_pass), (out,)):
        return out
    grid = max(1, min(-(-n // BLOCK), BLOCKS_PER_SM * _build.sm_count(dev)))
    err = _build.library().ota_aggregate_f32(
        wg.data_ptr(), wg.stride(0), bits.data_ptr(), bits.stride(0),
        nbits.data_ptr(), params.data_ptr(), p_pass.data_ptr(),
        out.data_ptr(), n, n_clusters, int(n_clients), grid, BLOCK,
        _build.current_stream_handle(dev))
    _build.check(err, "ota_aggregate")
    aggregate_counter.count += 1
    return out


def launch_aggregate_fused(wg: torch.Tensor, keys, params: torch.Tensor,
                           p_pass: torch.Tensor, n_clients: int,
                           out: torch.Tensor,
                           partitionable: bool) -> torch.Tensor:
    """Launch K4 on prepared CUDA operands: ``wg`` (C, n) float32 with
    unit stride along n, the section's (2, 2) keys [gain, AWGN] (host
    uint32 values), the ``aggregate_params`` row, ``p_pass`` (C,), ``out``
    (n,) float32 and the ``bits`` layout (``rng.threefry_partitionable``)."""
    n_clusters, n = wg.shape
    _check_aggregate_operands(wg, params, p_pass, out)
    k = [int(v) for v in rng.as_key(keys).reshape(4).tolist()]
    if n == 0 or not kernel_launch("ota_aggregate_fused", 0.0,
                                   (wg, params, p_pass), (out,)):
        return out
    err = _build.library().ota_aggregate_fused_f32(
        wg.data_ptr(), wg.stride(0), k[0], k[1], k[2], k[3],
        params.data_ptr(), p_pass.data_ptr(), out.data_ptr(), n, n_clusters,
        int(n_clients), int(bool(partitionable)),
        _build.current_stream_handle(wg.device))
    _build.check(err, "ota_aggregate_fused")
    fused_counter.count += 1
    return out


# --------------------------------------------------------------------------
# the stream words: drawn on the card by csrc/threefry_stream.cu
# --------------------------------------------------------------------------

def _draw_device(device):
    """None for the host (the plain draw), else the CUDA device to draw on
    (or ``meta`` inside a cost trace); raises on any other device."""
    if device is None:
        return None
    dev = torch.device(device)
    if dev.type == "cpu":
        return None
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _key_table(keys, dev):
    """(lead shape, (K, 2) int32 bit patterns on ``dev``) of a key table."""
    keys = rng.as_key(keys)
    lead = tuple(keys.shape[:-1])
    return lead, rng.to_bit_pattern(keys.reshape(-1, 2)).to(dev)


def launch_chunked(keys: torch.Tensor, start: int, out: torch.Tensor):
    """Launch the chunk-quantized draw on prepared CUDA operands: ``keys``
    (K, 2) int32 bit patterns, ``out`` (K, length) int32 with unit stride
    along the words (rows may be strided), words [start, start + length)
    of each key's stream in the layout in force."""
    n_keys, length = out.shape
    _check_draw(keys, out, n_keys)
    if start < 0:
        raise ValueError(f"range [{start}, {start} + {length}) of a stream")
    if n_keys and length and kernel_launch("threefry_chunked", 0.0, (keys,),
                                           (out,)):
        err = _build.library().threefry_chunked_u32(
            keys.data_ptr(), n_keys, int(start), int(length), out.stride(0),
            int(rng.threefry_partitionable()), out.data_ptr(),
            _build.current_stream_handle(out.device))
        _build.check(err, "threefry_chunked")
        stream_counter.count += 1
    return out


MAX_DRAW_KEYS = 65535     # keys of one draw launch (a grid dimension)


def launch_flat(keys: torch.Tensor, out: torch.Tensor):
    """Launch the flat draw on prepared CUDA operands: ``keys`` (K, 2)
    int32 bit patterns, ``out`` (K, n) int32 as above: ``bits(key, n)``
    in the layout in force."""
    n_keys, n = out.shape
    _check_draw(keys, out, n_keys)
    if n >= rng.MASK32:
        raise ValueError(f"bits: n={n} needs the blocked draw of 2**32 words")
    if n_keys and n and kernel_launch("threefry_flat", 0.0, (keys,),
                                      (out,)):
        err = _build.library().threefry_flat_u32(
            keys.data_ptr(), n_keys, int(n), out.stride(0),
            int(rng.threefry_partitionable()), out.data_ptr(),
            _build.current_stream_handle(out.device))
        _build.check(err, "threefry_flat")
        bits_counter.count += 1
    return out


def _check_draw(keys: torch.Tensor, out: torch.Tensor, n_keys: int) -> None:
    if (keys.dtype != torch.int32 or keys.device != out.device
            or tuple(keys.shape) != (n_keys, 2) or not keys.is_contiguous()):
        raise ValueError(f"keys must be a contiguous ({n_keys}, 2) int32 "
                         f"CUDA tensor")
    _check_rows("out", out, tuple(out.shape), torch.int32, out.device)
    if n_keys > MAX_DRAW_KEYS:
        raise ValueError(f"{n_keys} keys: one launch draws at most "
                         f"{MAX_DRAW_KEYS}")


def launch_stream(keys, start: int, length: int, device) -> torch.Tensor:
    """Words [start, start + length) of each (..., 2) key's chunk-quantized
    stream, drawn on the CUDA ``device`` in one launch: (..., length)
    int32 bit patterns."""
    dev = torch.device(device)
    lead, k = _key_table(keys, dev)
    out = torch.empty((k.shape[0], length), dtype=torch.int32, device=dev)
    return launch_chunked(k, start, out).reshape(lead + (length,))


def launch_bits(keys, n: int, device) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` for each (..., 2) key, drawn on the
    CUDA ``device`` in one launch: (..., n) int32."""
    dev = torch.device(device)
    lead, k = _key_table(keys, dev)
    out = torch.empty((k.shape[0], n), dtype=torch.int32, device=dev)
    return launch_flat(k, out).reshape(lead + (n,))


def stream_range(keys, start: int, length: int, device=None) -> torch.Tensor:
    """Words [start, start + length) of each (..., 2) key's chunk-quantized
    stream on ``device``: the card's kernel there, the plain draw on the
    host (None or "cpu")."""
    dev = _draw_device(device)
    if dev is None:
        return ref_stream_range(keys, start, length, device)
    return launch_stream(keys, start, length, dev)


def chunk_stream(keys, j0: int, j1: int, device=None) -> torch.Tensor:
    """Chunks j0..j1 (inclusive) of each key's stream, end to end."""
    dev = _draw_device(device)
    if dev is None:
        return ref_chunk_stream(keys, j0, j1, device)
    return launch_stream(keys, j0 * CHUNK, (j1 - j0 + 1) * CHUNK, dev)


def chunked_stream(keys, length: int, device=None) -> torch.Tensor:
    """The first ``length`` words of each key's chunk-quantized stream."""
    dev = _draw_device(device)
    if dev is None:
        return ref_chunked_stream(keys, length, device)
    return launch_stream(keys, 0, length, dev)


def bits(keys, n: int, device=None) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` for each key of a (..., 2) table."""
    dev = _draw_device(device)
    if dev is None:
        return ref_bits(keys, n, device)
    return launch_bits(keys, n, dev)


def _slab_p_pass(params: torch.Tensor, n_clusters: int) -> torch.Tensor:
    # the same torch call the plain version makes, on the same device
    return pass_probability(params[:n_clusters], params[n_clusters])


def ota_aggregate(wg: torch.Tensor, bits: torch.Tensor, nbits: torch.Tensor,
                  sigma2, h_th, noise_std, ota_on,
                  n_clients: int) -> torch.Tensor:
    """Whole-slab OTA estimate (eqs. 8-10): the (P,) ĝ of a (C, P) float32
    weighted slab from its (C, P) gain words and (P,) noise words (int32
    bit patterns, the packed key schedule's). One K3 launch on the card;
    the plain version for CPU tensors."""
    n_clusters, n = wg.shape
    if tuple(bits.shape) != (n_clusters, n) or tuple(nbits.shape) != (n,):
        raise ValueError(f"bits {tuple(bits.shape)} / nbits "
                         f"{tuple(nbits.shape)} do not match a ({n_clusters}, "
                         f"{n}) slab")
    if wg.device.type == "cpu":
        return ota_aggregate_slab_ref(wg, bits, nbits, sigma2, h_th,
                                      noise_std, ota_on, n_clients)
    if wg.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {wg.device}")
    dev = wg.device
    params = aggregate_params(sigma2, h_th, noise_std, ota_on, n_clusters,
                              device=dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    return launch_aggregate(wg.to(torch.float32), bits, nbits, params,
                            _slab_p_pass(params, n_clusters), n_clients, out)


def _ota_aggregate_fused_impl(wg: torch.Tensor, section_keys,
                              section_lens, sigma2, h_th, noise_std, ota_on,
                              n_clients: int, bits=None,
                              nbits=None) -> torch.Tensor:
    """The packed slab path, section by section: ``wg`` is the (C, P)
    weighted slab, ``section_keys`` the (S, 2, 2) keys [section][gain |
    AWGN] of the packer's sections in layout order and ``section_lens``
    their lengths. Each non-empty section runs its own launch on its
    columns of the slab, read in place: K4, which draws the section's
    chunk-quantized words in the kernel, or, when the (C, P) ``bits`` and
    (P,) ``nbits`` words are supplied, K3 on their columns. Both give the
    same values. Returns the (P,) estimate."""
    n_clusters, p = wg.shape
    if sum(int(l) for l in section_lens) != p:
        raise ValueError(f"section lengths {list(section_lens)} do not add "
                         f"up to the slab's {p} entries")
    if (bits is None) != (nbits is None):
        raise ValueError("supply both bits and nbits, or neither")
    keys = rng.as_key(section_keys)
    dev = wg.device
    wg32 = wg.to(torch.float32)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(p, dtype=torch.float32, device=dev)
    if dev.type == "cuda":
        params = aggregate_params(sigma2, h_th, noise_std, ota_on,
                                  n_clusters, device=dev)
        p_pass = _slab_p_pass(params, n_clusters)
        partitionable = rng.threefry_partitionable()
    off = 0
    for s, length in enumerate(int(l) for l in section_lens):
        if not length:
            continue
        cols = slice(off, off + length)
        if dev.type == "cpu":
            if bits is None:
                out[cols] = ota_aggregate_fused_ref(
                    wg32[:, cols], keys[s], sigma2, h_th, noise_std, ota_on,
                    n_clients)
            else:
                out[cols] = ota_aggregate_slab_ref(
                    wg32[:, cols], bits[:, cols], nbits[cols], sigma2, h_th,
                    noise_std, ota_on, n_clients)
        elif bits is None:
            launch_aggregate_fused(wg32[:, cols], keys[s], params, p_pass,
                                   n_clients, out[cols], partitionable)
        else:
            launch_aggregate(wg32[:, cols], bits[:, cols], nbits[cols],
                             params, p_pass, n_clients, out[cols])
        off += length
    return out


# --------------------------------------------------------------------------
# K6: mask, weighted apply and |M| count over every cluster's stream
# --------------------------------------------------------------------------

def mask_count_params(sigma2_all, h_th, ota_on, w, me, live_all,
                      n_clusters: int, device=None) -> torch.Tensor:
    """K6's params row, laid out as the reference's (1, 2C+4) block:
    [σ²_0..σ²_{C-1}, H_th, ota_on, w, me, live_0..live_{C-1}]."""
    live_v = (torch.ones(n_clusters, dtype=torch.float32, device=device)
              if live_all is None else
              torch.as_tensor(live_all, dtype=torch.float32,
                              device=device).reshape(n_clusters))
    return torch.cat([
        torch.as_tensor(sigma2_all, dtype=torch.float32,
                        device=device).reshape(n_clusters),
        _scalar(h_th, device), _scalar(ota_on, device), _scalar(w, device),
        _scalar(float(me), device), live_v])


def launch_mask_count(x: torch.Tensor, bits: torch.Tensor,
                      params: torch.Tensor, p_pass: torch.Tensor,
                      out: torch.Tensor, cnt: torch.Tensor):
    """Launch K6 on prepared CUDA operands: ``x`` (n,) contiguous float32,
    ``bits`` (C, n) int32 with unit stride along n (rows may be strided),
    the ``mask_count_params`` row, ``p_pass`` (C,), and ``out``/``cnt``
    (n,) float32. Checks what the kernel assumes and raises otherwise."""
    n_clusters, n = bits.shape
    dev = x.device
    if (x.dtype != torch.float32 or not x.is_contiguous()
            or x.numel() != n):
        raise ValueError(f"x must be a contiguous float32 CUDA tensor of "
                         f"{n} entries")
    _check_rows("bits", bits, (n_clusters, n), torch.int32, dev)
    for name, t, size in (("params", params, 2 * n_clusters + 4),
                          ("p_pass", p_pass, n_clusters), ("out", out, n),
                          ("cnt", cnt, n)):
        if (t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous() or t.numel() != size):
            raise ValueError(f"{name} must be a contiguous float32 CUDA "
                             f"tensor of {size} elements")
    if 8 * n_clusters > _SMEM_LIMIT:
        raise ValueError(f"C={n_clusters} clusters do not fit the shared "
                         f"memory of one block")
    if n == 0 or not kernel_launch("ota_mask_count", 0.0,
                                   (x, bits, params, p_pass), (out, cnt)):
        return out, cnt
    grid = max(1, min(-(-n // BLOCK), BLOCKS_PER_SM * _build.sm_count(dev)))
    err = _build.library().ota_mask_count_f32(
        x.data_ptr(), bits.data_ptr(), bits.stride(0), params.data_ptr(),
        p_pass.data_ptr(), out.data_ptr(), cnt.data_ptr(), n, n_clusters,
        grid, BLOCK, _build.current_stream_handle(dev))
    _build.check(err, "ota_mask_count")
    mask_count_counter.count += 1
    return out, cnt


def ota_mask_count_apply(x: torch.Tensor, bits_all: torch.Tensor, me: int,
                         sigma2_all, h_th, ota_on, weight, live_all=None):
    """(M_me ∘ (w·x), Σ_l M_l) shaped like ``x``, both float32, for ONE
    leaf of the distributed step's backward.

    ``bits_all`` is the (C, n) int32 stack of EVERY cluster's stream slice
    for the leaf (a column slice of the (C, section) streams is fine: rows
    may be strided). The masks are pure functions of the streams, so the
    |M| count needs no collective. ``me`` is this device's cluster index;
    ``sigma2_all`` and ``live_all`` are (C,), None meaning all live."""
    n_clusters = bits_all.shape[0]
    n = x.numel()
    if tuple(bits_all.shape) != (n_clusters, n):
        raise ValueError(f"bits {tuple(bits_all.shape)} do not match a leaf "
                         f"of {n} entries")
    if not 0 <= int(me) < n_clusters:
        raise ValueError(f"cluster {me} is not one of {n_clusters}")
    flat = x.reshape(-1)
    if x.device.type == "cpu":
        out, cnt = ota_mask_count_ref(flat, bits_all, me, sigma2_all, h_th,
                                      ota_on, weight, live_all=live_all)
        return out.reshape(x.shape), cnt.reshape(x.shape)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {x.device}")
    dev = x.device
    params = mask_count_params(sigma2_all, h_th, ota_on, weight, me,
                               live_all, n_clusters, device=dev)
    # the same torch call the plain version makes, on the same device
    p_pass = pass_probability(params[:n_clusters], params[n_clusters])
    out = torch.empty(n, dtype=torch.float32, device=dev)
    cnt = torch.empty(n, dtype=torch.float32, device=dev)
    launch_mask_count(flat.to(torch.float32).contiguous(), bits_all, params,
                      p_pass, out, cnt)
    return out.reshape(x.shape), cnt.reshape(x.shape)


# --------------------------------------------------------------------------
# K7: the gain-threshold mask and apply
# --------------------------------------------------------------------------

def channel_params_row(sigma2, h_th, ota_on, device=None) -> torch.Tensor:
    """K7's params row, laid out as the reference's (1, 3) block:
    [σ², H_th, ota_on]."""
    return torch.cat([_scalar(v, device) for v in (sigma2, h_th, ota_on)])


def launch_channel(x: torch.Tensor, bits: torch.Tensor,
                   params: torch.Tensor, out: torch.Tensor,
                   mask: torch.Tensor):
    """Launch K7 on prepared CUDA operands: ``x``, ``bits`` (int32),
    ``out`` and ``mask`` contiguous (n,) tensors, float32 but ``bits``,
    and the ``channel_params_row``. Checks what the kernel assumes and
    raises otherwise."""
    n = x.numel()
    dev = x.device
    for name, t, dtype, size in (("x", x, torch.float32, n),
                                 ("bits", bits, torch.int32, n),
                                 ("params", params, torch.float32, 3),
                                 ("out", out, torch.float32, n),
                                 ("mask", mask, torch.float32, n)):
        if (t.dtype != dtype or t.device != dev or not t.is_contiguous()
                or t.numel() != size):
            raise ValueError(f"{name} must be a contiguous {dtype} CUDA "
                             f"tensor of {size} elements")
    if n == 0 or not kernel_launch("ota_channel", 0.0, (x, bits, params),
                                   (out, mask)):
        return out, mask
    grid = max(1, min(-(-n // BLOCK), BLOCKS_PER_SM * _build.sm_count(dev)))
    err = _build.library().ota_channel_f32(
        x.data_ptr(), bits.data_ptr(), params.data_ptr(), out.data_ptr(),
        mask.data_ptr(), n, grid, BLOCK, _build.current_stream_handle(dev))
    _build.check(err, "ota_channel")
    channel_counter.count += 1
    return out, mask


def _ota_channel_impl(x: torch.Tensor, bits: torch.Tensor, sigma2, h_th,
                      ota_on):
    """(M ∘ x, M) shaped like the float32 ``x`` under the gain law, from
    same-shape int32 ``bits``: the single home of the (1, 3) params
    layout (the packed ω̃ gather of ``repro_torch.core.hota`` calls it)."""
    if tuple(bits.shape) != tuple(x.shape):
        raise ValueError(f"bits {tuple(bits.shape)} do not match x "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        out, mask, _ = ota_channel_ref(x, bits, sigma2, h_th, ota_on)
        return out, mask
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"K7 takes float32, got {x.dtype}")
    dev = x.device
    params = channel_params_row(sigma2, h_th, ota_on, device=dev)
    out = torch.empty_like(x)
    mask = torch.empty_like(x)
    launch_channel(x.contiguous().reshape(-1), bits.contiguous().reshape(-1),
                   params, out.reshape(-1), mask.reshape(-1))
    return out, mask


def _padded_bits(key, n: int, device) -> torch.Tensor:
    """The first ``n`` words of ``jax.random.bits(key, slab.shape)`` for
    the (rows, 128) slab the reference pads an n-entry tensor to."""
    return bits(key, slab_rows(n) * LANE, device=device)[:n]


def ota_channel(x: torch.Tensor, key, sigma2, h_th, ota_on=1.0):
    """Channel mask and apply on any-shape float32 ``x`` under ``key``'s
    words: (M ∘ x, M) shaped like x, through K7 on the card."""
    bits = _padded_bits(key, x.numel(), x.device).reshape(x.shape)
    return _ota_channel_impl(x, bits, sigma2, h_th, ota_on)


def ota_channel_reference(x: torch.Tensor, key, sigma2, h_th, ota_on=1.0):
    """``ota_channel`` through the plain version, on x's device."""
    bits = _padded_bits(key, x.numel(), x.device).reshape(x.shape)
    out, mask, _ = ota_channel_ref(x, bits, sigma2, h_th, ota_on)
    return out, mask


def ota_aggregate_reference(wg: torch.Tensor, bits: torch.Tensor,
                            nbits: torch.Tensor, sigma2, h_th, noise_std,
                            ota_on, n_clients: int) -> torch.Tensor:
    """``ota_aggregate`` through its plain version on the same words, on
    wg's device (the reference's oracle name)."""
    return ota_aggregate_slab_ref(wg, bits, nbits, sigma2, h_th, noise_std,
                                  ota_on, n_clients)
