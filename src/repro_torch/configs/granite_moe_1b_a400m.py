"""granite-moe-1b-a400m — fine-grained MoE, 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_ff=512,
        vocab=49155,
        moe=True,
        n_experts=32,
        top_k=8,
        moe_d_ff=512,
        router_type="softmax",
        tie_embeddings=True,
        source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
    )


def smoke() -> ArchConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64, moe_d_ff=64,
        n_experts=8, top_k=2, vocab=256, loss_chunk=64,
    )
