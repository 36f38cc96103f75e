"""internvl2-76b — VLM: InternViT (stub) + llama-3-70b-class LM backbone
[arXiv:2404.16821; unverified].

Per the assignment spec the modality frontend is a stub: ``input_specs()``
provides 256 projected patch embeddings per sample, prepended to the token
sequence; loss is masked over the vision prefix.
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-76b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab=128256,
        rope_theta=500_000.0,
        vision_prefix=256,
        loss_chunk=512,
        source="[arXiv:2404.16821; unverified]",
    )


def smoke() -> ArchConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
        vision_prefix=8, loss_chunk=64,
    )
