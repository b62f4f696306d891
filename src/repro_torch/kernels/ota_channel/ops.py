"""Wrappers of the OTA channel kernels: K1 (client fold) and K5 (mask and
weighted apply).

Ports of ``repro.kernels.ota_channel.ops``:

* ``ota_client_fold_apply``: one leaf's PS estimate ĝ from its RAW (C, N,
  *shape) client gradients, the (C, N) loss weights and the leaf's slices
  of the gain and noise bit streams (``csrc/ota_client_fold.cu``);
* ``ota_mask_weight_apply``: (M ∘ (w·x), M) for one leaf and one stream
  slice (``csrc/ota_mask_weight.cu``);
* ``ota_stream_fold_apply``: one (leaf, cluster) term of the streaming
  engines, the (N,) client weights folded with one torch product and then
  ``ota_mask_weight_apply``.

For CPU tensors each runs its plain version (``ref``); for CUDA tensors it
launches its kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ota_channel.ref import (
    ota_aggregate_client_ref, ota_mask_weight_ref, ota_stream_fold_ref,
    pass_probability,
)

client_fold_counter = _build.LaunchCounter("ota_client_fold")
mask_weight_counter = _build.LaunchCounter("ota_mask_weight")

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
    if n == 0:
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
    if g.device.type != "cuda":
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
    if n == 0:
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
    if x.device.type != "cuda":
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
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    wg = torch.matmul(p_c.to(torch.float32).reshape(n_cl),
                      flat.to(torch.float32))
    out, mask = ota_mask_weight_apply(wg, bits, sigma2_c, h_th, ota_on, 1.0)
    if live_c is not None:
        lv = (torch.as_tensor(live_c, dtype=torch.float32, device=g.device)
              > 0.5).to(torch.float32)
        out, mask = out * lv, mask * lv
    return out.reshape(shape), mask.reshape(shape)
