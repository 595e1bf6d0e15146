"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every wrapper routes by the device of its inputs: CPU tensors take the plain
version, CUDA tensors launch the kernel built from ``csrc/`` (see
``_build.py``).  Kernels are built at first launch, never at import.
"""
