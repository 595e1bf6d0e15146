"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Each kernel is a ``torch.library`` operator in the ``bmcnet`` namespace,
registered when this package is imported: the plain version for the CPU
key, the launch of the kernel built from ``csrc/`` (see ``_build.py``) for
the CUDA key, and a fake implementation that gives the output's shape and
dtype for tracing (``torch.export``).  A program exported with these
operators loads once this package is imported.  Kernels are built at first
launch, never at import.

* ``rasterize``: event windows -> count images
  (``bmcnet::rasterize_counts_compact``, ``bmcnet::rasterize_counts_f32``);
* ``quantize``: bf16 / float32 -> int8 at per-lane scales
  (``bmcnet::quantize_act``);
* ``qmm``: the W8A8 1x1 convolution (``bmcnet::quant_matmul``);
* ``qconv``: the W8A8 3x3 convolution (``bmcnet::quant_conv3x3``).
"""

from bmcnet_esr_torch.kernels import qconv, qmm, quantize, rasterize

__all__ = ["qconv", "qmm", "quantize", "rasterize"]
