"""Architecture + input-shape configuration schema.

A copy of the JAX package's ``repro/configs/base.py`` (it imports no JAX;
the port keeps its own copy). One :class:`ArchConfig` instance per assigned
architecture (see ``repro_torch/configs/<arch>.py``), plus reduced
``smoke()`` variants for CPU tests. The four assigned input shapes are
global constants here.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention details
    qk_norm: bool = False
    attn_bias: bool = False
    rope_theta: float = 10_000.0
    window: int = 0  # sliding-window size for the attention branch (0 = full)

    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden (fine-grained); 0 -> d_ff
    first_dense_layers: int = 0
    router_type: str = "softmax"  # softmax | sigmoid (deepseek aux-free)
    capacity_factor: float = 1.25

    # MLA (deepseek)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # SSM branch (hymba) / mLSTM (xlstm)
    ssm: bool = False  # parallel mamba(SSD)-style branch in each layer
    ssm_state: int = 16
    mlstm: bool = False  # pure mLSTM mixer (no separate FFN when d_ff == 0)
    chunk: int = 128  # chunkwise-recurrence chunk length

    # encoder-decoder (whisper)
    encdec: bool = False
    enc_layers: int = 0
    enc_seq: int = 1500  # frontend-stub frames (30 s Whisper window)

    # VLM (internvl): patch-embedding stub tokens prepended to the sequence
    vision_prefix: int = 0

    # numerics / misc
    dtype: str = "bfloat16"
    opt_moment_dtype: str = "float32"  # bf16 halves optimizer HBM (671b needs it)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    remat: str = "nothing"  # nothing | dots | full  (activation ckpt policy)
    loss_chunk: int = 1024  # sequence chunking for the fp32 softmax-xent
    attn_q_block: int = 1024  # q-block rows in blockwise attention (XLA path)

    source: str = ""  # provenance note ([hf:...] / [arXiv:...])

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k? (SSM state and/or windowed attention)"""
        return self.mlstm or (self.ssm and self.window > 0)

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def with_(self, **kw: Any) -> "ArchConfig":
        return replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for MODEL_FLOPS."""
        e, v, h = self.d_model, self.vocab, self.resolved_head_dim
        n_emb = v * e * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.mla:
            per_layer += e * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                self.qk_nope_dim + self.qk_rope_dim
            )
            per_layer += e * (self.kv_lora_rank + self.qk_rope_dim)
            per_layer += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
            per_layer += self.n_heads * self.v_head_dim * e
        else:
            per_layer += e * self.n_heads * h + 2 * e * self.n_kv_heads * h + self.n_heads * h * e
        if self.ssm:  # parallel SSD branch
            per_layer += e * self.n_heads * h  # x proj
            per_layer += 2 * e * self.n_heads * self.ssm_state + e * self.n_heads  # B,C,dt
            per_layer += self.n_heads * h * e  # out proj
        if self.mlstm:
            per_layer += 4 * e * self.n_heads * h + 2 * e * self.n_heads  # qkv+o+gates
        n_moe_layers = (self.n_layers - self.first_dense_layers) if self.moe else 0
        n_dense_layers = self.n_layers - n_moe_layers
        if self.d_ff:
            per_dense_ffn = 3 * e * self.d_ff
        else:
            per_dense_ffn = 0
        moe_ffn = 0
        if self.moe:
            f = self.resolved_moe_d_ff
            moe_ffn = 3 * e * f * (self.n_experts + self.n_shared_experts) + e * self.n_experts
        total = n_emb + self.n_layers * per_layer
        total += n_dense_layers * per_dense_ffn + n_moe_layers * moe_ffn
        if self.encdec:
            enc_layer = e * self.n_heads * h * 2 + 2 * e * self.n_kv_heads * h + 3 * e * self.d_ff
            total += self.enc_layers * (enc_layer + per_layer)  # + decoder cross-attn approx
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.param_count()
        f = self.resolved_moe_d_ff
        e = self.d_model
        n_moe_layers = self.n_layers - self.first_dense_layers
        inactive = n_moe_layers * 3 * e * f * (self.n_experts - self.top_k)
        return int(self.param_count() - inactive)
