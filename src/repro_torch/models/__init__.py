"""Model zoo on PyTorch: GQA and MLA (dense or MoE), hybrid, mLSTM, encoder-decoder.

Params are plain nested dicts with layers stacked on a leading ``L`` axis,
with the JAX package's paths and shapes (``repro/models``), so the serve
CMIs of both packages are interchangeable. Prefill and training attention
(the encoder's and the cross attention too) run K3
(``repro_torch.kernels.flash_attention``).
"""

from repro_torch.models.model import Model, TensorSpec, input_specs, params_from_numpy  # noqa: F401
