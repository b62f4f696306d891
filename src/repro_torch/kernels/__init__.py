"""Hand-written CUDA kernels for Hopper (``sm_90a``) in place of the
reference's Pallas TPU kernels, each as <name>/{csrc/*.cu, ops.py,
ref.py}: the kernel source, the wrapper that launches it (counted) on a
CUDA tensor or takes the plain PyTorch version on a CPU tensor, and the
plain version. Importing this package builds nothing: the library is
compiled and loaded at a wrapper's first launch (``_build``).

As in the reference, the facade's names ``ota_channel``,
``masked_gradnorm`` and ``flash_attention`` are the wrapper functions,
which shadow the subpackages of the same names as attributes of this
package: reach a subpackage's modules with ``from
repro_torch.kernels.ota_channel import ops``, not with ``import
repro_torch.kernels.ota_channel.ops as ...``.
"""
from repro_torch.kernels.flash_attention.ops import (
    flash_attention, flash_attention_reference,
)
from repro_torch.kernels.masked_gradnorm.ops import (
    masked_gradnorm, masked_gradnorm_reference,
)
from repro_torch.kernels.ota_channel.ops import (
    ota_aggregate, ota_aggregate_reference, ota_channel,
    ota_channel_reference,
)

__all__ = [
    "ota_aggregate", "ota_aggregate_reference",
    "ota_channel", "ota_channel_reference",
    "masked_gradnorm", "masked_gradnorm_reference",
    "flash_attention", "flash_attention_reference",
]
