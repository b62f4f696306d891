"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    The port runs on the card unless the caller asks for the CPU: a CUDA
    device with no card present raises rather than silently running the
    plain CPU versions of the kernels. ``meta`` is the dry run's device
    (``launch.dryrun``): shapes and dtypes only, nothing allocated or
    computed."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r} (cuda, cpu or "
                         f"meta)")
    return dev
