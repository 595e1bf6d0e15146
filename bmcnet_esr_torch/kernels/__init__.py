"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every wrapper routes by the device of its inputs: CPU tensors take the plain
version, CUDA tensors launch the kernel built from ``csrc/`` (see
``_build.py``).  Kernels are built at first launch, never at import.

* ``rasterize``: event windows -> count images;
* ``quantize``: ``quantize_act``, bf16 / float32 -> int8 at per-lane scales;
* ``qmm``: ``quant_matmul``, the W8A8 1x1 convolution;
* ``qconv``: ``quant_conv3x3``, the W8A8 3x3 convolution.
"""
