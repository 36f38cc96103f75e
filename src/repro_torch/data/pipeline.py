"""Deterministic, checkpointable data pipeline.

A copy of the JAX package's ``repro/data/pipeline.py``: the cursor (seed +
step counter) lives inside the training state, so a CMI restore resumes
the exact token stream, and a batch is a pure function of the cursor.
Batches are counter-based Philox draws with a zipf-ish marginal, bitwise
equal to the reference's for the same seed and step.

The modality stubs are the reference's draws too: the vision prefix's
patch embeddings (``vis_embeds``, (B, P, E), drawn after the tokens) and
the encoder-decoder's audio frames (``enc_frames``, (B, enc_seq, E)) are
float32 Philox normals from the same generator, rounded to bf16 and
multiplied by bf16 0.1. The reference rounds and
multiplies with ``ml_dtypes``; here both are done on the bits with numpy,
rounding to nearest even as ``ml_dtypes`` does (the product of two bf16
values is exact in float32, so it is rounded once). Every leaf of a batch
is a numpy array: each stub is its bf16 bits as uint16, bitwise the
reference's array, and ``distributed.steps.batch_to_device`` views them as
bf16.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.configs.base import ArchConfig


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 (finite) -> the uint16 bits of its bf16 rounding to nearest even."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def bf16_values(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bits -> their float32 values (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _bf16_stub(rng: np.random.Generator, shape: tuple[int, ...]) -> np.ndarray:
    """The reference's modality stub as bf16 bits: a float32 normal draw
    rounded to bf16, times bf16 0.1 (exact in float32, rounded once)."""
    draw = rng.standard_normal(shape, dtype=np.float32)
    tenth = bf16_values(bf16_bits(np.float32(0.1)))
    return bf16_bits(bf16_values(bf16_bits(draw)) * tenth)


class TokenPipeline:
    def __init__(self, cfg: ArchConfig, seq_len: int, global_batch: int, seed: int = 0):
        self.cfg = cfg
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed

    def init_state(self) -> dict[str, Any]:
        return {"data_step": 0, "seed": self.seed}

    def batch_at(self, state: dict[str, Any]) -> tuple[dict[str, np.ndarray], dict[str, Any]]:
        """Returns (batch, next_state). Pure function of the cursor."""
        step = int(state["data_step"])
        rng = np.random.Generator(np.random.Philox(key=int(state["seed"]), counter=step))
        b, s = self.global_batch, self.seq_len
        # zipf-flavoured token ids in [0, vocab)
        raw = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
        tokens_full = (raw % self.cfg.vocab).astype(np.int32)
        batch = {"tokens": tokens_full[:, :s], "labels": tokens_full[:, 1:]}
        if self.cfg.vision_prefix:
            batch["vis_embeds"] = _bf16_stub(rng, (b, self.cfg.vision_prefix, self.cfg.d_model))
        if self.cfg.encdec:
            batch["enc_frames"] = _bf16_stub(rng, (b, self.cfg.enc_seq, self.cfg.d_model))
        return batch, {"data_step": step + 1, "seed": state["seed"]}
