"""PyTorch / CUDA port of bmcnet_esr_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's layout (``ops``, ``models``, ``data``,
``inference``, ``losses``, ``utils``, ``vis``, ``cli``) plus ``kernels`` and
``csrc``, the hand-written CUDA kernels that replace the JAX package's
Pallas kernels.  Importing the package loads neither JAX nor the JAX
package, and builds nothing.
"""

__version__ = "0.1.0"
