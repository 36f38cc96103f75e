"""Deterministic, checkpointable data pipeline.

A copy of the JAX package's ``repro/data/pipeline.py`` (numpy only): the
cursor (seed + step counter) lives inside the training state, so a CMI
restore resumes the exact token stream, and a batch is a pure function of
the cursor. Batches are counter-based Philox draws with a zipf-ish marginal,
bitwise equal to the reference's for the same seed and step.

The reference also draws modality stubs (vision patch embeddings, audio
frames) as numpy bfloat16, which needs ``ml_dtypes``; the port's models
refuse those configurations (``models.transformer.check_supported``), and so
does this pipeline, until the model slice that runs them.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.configs.base import ArchConfig

_LATER = "is not ported yet (ROADMAP queue 1, item 11: models and training)"


class TokenPipeline:
    def __init__(self, cfg: ArchConfig, seq_len: int, global_batch: int, seed: int = 0):
        if cfg.vision_prefix or cfg.encdec:
            raise NotImplementedError(f"{cfg.name}: the vision/audio input stubs {_LATER}")
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
        return batch, {"data_step": step + 1, "seed": state["seed"]}
