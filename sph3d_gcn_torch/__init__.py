"""SPH3D-GCN in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch counterpart of ``sph3d_gcn_tpu``: the same module layout
(``configs``, ``data``, ``ops``, ``nn``, ``models``, ``train``,
``utils``) and the same tensor layouts at every public function, so each
module can be held against its JAX counterpart on the same inputs.

Every op that the JAX package wrote as a Pallas TPU kernel has two
versions here: a plain PyTorch version, used for tensors on the CPU, and a
CUDA kernel built from ``csrc/`` at first use (``_build.py``), launched for
tensors on a CUDA device. Nothing falls back from one to the other: a CUDA
tensor goes to the kernel or the call raises.

This package imports neither JAX nor the JAX package: it carries its
own configs (``configs``), records, datasets and augmentations
(``data``), and command-line entry points (``cli``).
"""

from sph3d_gcn_torch._build import kernel_launches, reset_kernel_launches

__version__ = "0.1.0"

__all__ = ["kernel_launches", "reset_kernel_launches"]
