"""Wrapper of the client-folded OTA kernel (K1).

``ota_client_fold_apply`` is the port of ``repro.kernels.ota_channel.ops
.ota_client_fold_apply``: one leaf's PS estimate ĝ from its RAW (C, N,
*shape) client gradients, the (C, N) loss weights and the leaf's slices
of the gain and noise bit streams. For CPU tensors it runs the plain
version (``ref.ota_aggregate_client_ref``); for CUDA tensors it launches
``csrc/ota_client_fold.cu`` or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ota_channel.ref import (
    ota_aggregate_client_ref, pass_probability,
)

counter = _build.LaunchCounter("ota_client_fold")

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
    counter.count += 1
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
