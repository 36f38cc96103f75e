"""deepseek-v3-671b — MLA + 1 shared / 256 routed experts top-8
[arXiv:2412.19437; hf].

Faithfulness notes (DESIGN.md §4): MLA (latent KV compression) implemented
with the decode-time absorbed formulation; sigmoid (aux-free) routing with a
static selection bias; the MTP auxiliary head is omitted; first 3 layers are
dense per the paper.
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,  # MLA: kv "heads" equal q heads post-expansion
        d_ff=18432,  # dense-layer / shared-expert scale uses moe_d_ff below
        vocab=129280,
        moe=True,
        n_experts=256,
        top_k=8,
        n_shared_experts=1,
        moe_d_ff=2048,
        first_dense_layers=3,
        router_type="sigmoid",
        mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_rope_dim=64,
        qk_nope_dim=128,
        v_head_dim=128,
        loss_chunk=512,
        opt_moment_dtype="bfloat16",  # 671B fp32 moments would not fit 512×16G
        source="[arXiv:2412.19437; hf]",
    )


def smoke() -> ArchConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, moe_d_ff=32,
        n_experts=8, top_k=2, first_dense_layers=1,
        q_lora_rank=32, kv_lora_rank=16, qk_rope_dim=8, qk_nope_dim=16,
        v_head_dim=16, vocab=256, loss_chunk=64,
    )
