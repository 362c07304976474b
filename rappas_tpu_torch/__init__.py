"""rappas-tpu-torch: the placement system on PyTorch and CUDA.

A port of the ``rappas_tpu`` package (JAX on a TPU) to PyTorch on an
NVIDIA H100.  The host modules are copies of their ``rappas_tpu``
counterparts under the same names; the device work of ``-p p`` placement
on a direct-layout table runs in CUDA kernels written for ``sm_90a``
(``csrc/``, built at first use by :mod:`rappas_tpu_torch._kernels`),
each beside its plain PyTorch version in
:mod:`rappas_tpu_torch.place.kernels`.

This package imports torch, numpy and the standard library only.
"""

__version__ = "0.1.0"

from rappas_tpu_torch.alphabet import DNA, AA, Alphabet  # noqa: F401
