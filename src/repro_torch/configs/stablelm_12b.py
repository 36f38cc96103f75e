"""stablelm-12b — dense GQA [hf:stabilityai/stablelm-2-12b; hf]."""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="stablelm-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=13824,
        vocab=100352,
        attn_bias=True,  # stablelm-2 uses qkv biases
        source="[hf:stabilityai/stablelm-2-1_6b; hf]",
    )


def smoke() -> ArchConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab=256,
        loss_chunk=64,
    )
