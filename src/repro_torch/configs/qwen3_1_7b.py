"""qwen3-1.7b — dense GQA with per-head qk RMSNorm [hf:Qwen/Qwen3-8B; hf]."""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-1.7b",
        family="dense",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=6144,
        vocab=151936,
        head_dim=128,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        source="[hf:Qwen/Qwen3-8B; hf]",
    )


def smoke() -> ArchConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        vocab=256, loss_chunk=64,
    )
