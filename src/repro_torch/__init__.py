"""PyTorch/CUDA port of Hierarchical Over-the-Air FedGradNorm.

The JAX package ``repro`` is the reference: this package mirrors its module
names (``core.sim``, ``core.ota``, ``kernels.ota_channel``, ...) so each
counterpart is easy to find, but it imports neither ``jax`` nor anything
from ``repro``. Plain tensor code is PyTorch; every Pallas kernel on the
ported path is a CUDA C++ kernel for Hopper (``kernels/**/csrc``), built
at first use by ``repro_torch.kernels._build``.

Entry points (``HotaSim``, ``paper_mlp_setup``, ``launch.serve.serve``)
run on ``device="cuda"`` unless the caller asks for ``device="cpu"``;
with no card present they raise instead of falling back. On CPU tensors the kernel wrappers take
their plain PyTorch versions.
"""
