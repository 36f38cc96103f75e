"""whisper-tiny — encoder-decoder audio backbone [arXiv:2212.04356; unverified].

Per the assignment spec the conv frontend is a stub: ``input_specs()``
provides 1500 precomputed frame embeddings (the 30 s Whisper window after
the 2×conv stem). The decoder mechanically follows the assigned shapes
(e.g. a 32k self-attention cache) even though nominal Whisper decodes ≤448
tokens — noted in DESIGN.md §4. Sinusoidal→learned positions simplified to
learned for both stacks.
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab=51865,
        attn_bias=True,
        encdec=True,
        enc_layers=4,
        enc_seq=1500,
        tie_embeddings=True,
        source="[arXiv:2212.04356; unverified]",
    )


def smoke() -> ArchConfig:
    return config().with_(
        n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, enc_seq=64, loss_chunk=64,
    )
