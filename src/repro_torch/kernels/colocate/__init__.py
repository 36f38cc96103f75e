from repro_torch.kernels.colocate.ops import colocate_match, colocate_match_plain  # noqa: F401
