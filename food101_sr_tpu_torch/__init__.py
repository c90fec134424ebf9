"""PyTorch/CUDA port of ``food101_sr_tpu`` for NVIDIA Hopper (H100).

The JAX package ``food101_sr_tpu`` stays the reference; this package holds
the same functions in PyTorch, module for module under the same names
(``ops``, ``models``, ``losses``, ``metrics``, ``parallel``), and replaces
each Pallas TPU kernel with a CUDA kernel written for ``sm_90a``
(``csrc/kernels.cu``, built by ``_build.py`` with nvcc and bound with
ctypes). It imports neither JAX nor anything of ``food101_sr_tpu``.

Tensors are (N, C, H, W) inside (the nets in channels-last memory, the
metrics in NCHW); public functions that take images keep the JAX
package's NHWC layout. Entry points run on ``device="cuda"`` unless the
caller passes another device; a kernel wrapper given a CPU tensor runs the
kernel's plain PyTorch version, and given a CUDA tensor launches the kernel
or raises.
"""
