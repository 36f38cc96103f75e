"""repro_torch: the NavP system on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``repro`` that keeps its module layout, so each
module here has one reference module there, and its on-disk CMI format, so
state crosses between the two packages through the store. Entry points run
on the CUDA card unless the caller passes a CPU device; asking for the card
where there is none raises. The Pallas TPU kernels on this path are CUDA
kernels written by hand for Hopper (``repro_torch.kernels``).
"""

__version__ = "0.1.0"
