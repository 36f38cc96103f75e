"""xlstm-1.3b — xLSTM[1:0]: pure mLSTM blocks [arXiv:2405.04517; unverified].

The assigned config (48L, d=2048, 4 heads, d_ff=0) matches the paper's
mLSTM block: the mixer includes its own up/down projections, so there is no
separate FFN sublayer. The published xLSTM[1:0] (all-mLSTM) variant is used
so the layer stack is scan-uniform; sLSTM is implemented and unit-tested in
``repro.models.ssm`` but not part of this config (DESIGN.md §4).
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        mlstm=True,
        chunk=128,
        source="[arXiv:2405.04517; unverified]",
    )


def smoke() -> ArchConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, vocab=256, chunk=16,
        loss_chunk=64,
    )
