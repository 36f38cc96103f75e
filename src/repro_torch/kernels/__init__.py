"""Hand-written CUDA kernels for Hopper: one per Pallas TPU kernel of the
JAX package on the port's path, and the chunked linear recurrence.

  delta_encode/  per-chunk changed bitmap for incremental CMIs (K1)
  colocate/      angular nearest-neighbour VIIRS→CrIS match (K2)
  flash_attention/  forward GQA flash attention for the model prefill (K3)
  linear_recurrence/  the chunked linear recurrence, forward and backward
                      (no Pallas kernel: the JAX package's is plain jnp)

Each ``ops.py`` holds the kernel's wrapper, its plain PyTorch version (the
recurrence's is ``models/ssm.py``'s ``_recurrence``) and a launch counter. The wrapper runs the plain version for CPU tensors and the
kernel for CUDA tensors; a kernel that cannot build or launch raises. The
CUDA sources are in ``csrc/``; ``_build`` compiles them with nvcc at the
first CUDA launch (never at import).
"""


def launch_counts(reset: bool = False) -> dict[str, int]:
    """Launch counts of this process's kernel wrappers (0 where none ran),
    with K3's launches of its tensor-core kernel as
    ``flash_attention_wgmma`` and the recurrence's backward launches as
    ``linear_recurrence_bwd``; ``reset`` sets them to 0 after reading."""
    from repro_torch.kernels.colocate import ops as colocate_ops
    from repro_torch.kernels.delta_encode import ops as delta_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.linear_recurrence import ops as recurrence_ops

    counters = {"delta_encode": delta_ops.changed_blocks,
                "colocate": colocate_ops.colocate_match,
                "flash_attention": flash_ops.flash_attention,
                "linear_recurrence": recurrence_ops.linear_recurrence}
    out = {name: int(fn.launches) for name, fn in counters.items()}
    out["flash_attention_wgmma"] = int(flash_ops.flash_attention.wgmma_launches)
    out["linear_recurrence_bwd"] = int(recurrence_ops.linear_recurrence.bwd_launches)
    if reset:
        for fn in counters.values():
            fn.launches = 0
        flash_ops.flash_attention.wgmma_launches = 0
        recurrence_ops.linear_recurrence.bwd_launches = 0
    return out
