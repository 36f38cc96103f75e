from repro_torch.kernels.delta_encode.ops import changed_blocks, changed_blocks_plain  # noqa: F401
