"""hymba-1.5b — hybrid: parallel attention ‖ SSM heads per layer
[arXiv:2411.13676; hf].

Adaptation notes (DESIGN.md §4): the SSM branch uses the SSD (Mamba-2 style)
chunkwise scalar-decay formulation — the TPU-native reformulation of the
selective scan; attention uses a 2048-token sliding window so long_500k is
sub-quadratic (Hymba's global-attn layers are folded into the window);
meta-tokens omitted.
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_ff=5504,
        vocab=32001,
        ssm=True,
        ssm_state=16,
        window=2048,
        chunk=128,
        source="[arXiv:2411.13676; hf]",
    )


def smoke() -> ArchConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
        ssm_state=8, window=32, chunk=16, loss_chunk=64,
    )
