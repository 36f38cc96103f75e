"""Hand-written CUDA kernels for Hopper, one per Pallas TPU kernel of the
JAX package on the port's path.

  delta_encode/  per-chunk changed bitmap for incremental CMIs (K1)
  colocate/      angular nearest-neighbour VIIRS→CrIS match (K2)
  flash_attention/  forward GQA flash attention for the model prefill (K3)

Each ``ops.py`` holds the kernel's wrapper, its plain PyTorch version and a
launch counter. The wrapper runs the plain version for CPU tensors and the
kernel for CUDA tensors; a kernel that cannot build or launch raises. The
CUDA sources are in ``csrc/``; ``_build`` compiles them with nvcc at the
first CUDA launch (never at import).
"""
