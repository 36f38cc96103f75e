"""command-r-plus-104b — dense GQA, no biases [hf:CohereForAI; unverified]."""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="command-r-plus-104b",
        family="dense",
        n_layers=64,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        d_ff=33792,
        vocab=256000,
        attn_bias=False,
        rope_theta=75_000_000.0,
        tie_embeddings=True,
        loss_chunk=512,  # 256k vocab: keep fp32 logits transient small
        source="[hf:CohereForAI/c4ai-command-r-v01; unverified]",
    )


def smoke() -> ArchConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128, vocab=512,
        loss_chunk=64,
    )
