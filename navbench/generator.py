"""The traffic generator: Zipf-flavoured token ids from the seed.

A copy of the program's ``repro_torch.data.pipeline.TokenPipeline.batch_at``
(token and label rows; counter-based Philox draws keyed by the seed, the
counter the step), so that the benchmark's inputs do not move when the
program does. ``test_navbench_yardstick.py`` holds it equal to the
program's. A serve request's prompt is drawn the same way, its counter the
request's index. The program is given only what these functions return.
"""

from __future__ import annotations

import numpy as np
import torch


def _rng(seed: int, counter: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=int(seed), counter=int(counter)))


def train_batch(seed: int, step: int, batch: int, seq_len: int, vocab: int,
                zipf_a: float) -> dict[str, np.ndarray]:
    """Step ``step``'s rows: ``tokens`` and ``labels`` (B, S) int32, the
    labels the tokens shifted by one."""
    raw = _rng(seed, step).zipf(zipf_a, size=(batch, seq_len + 1)).astype(np.int64)
    full = (raw % vocab).astype(np.int32)
    return {"tokens": full[:, :seq_len], "labels": full[:, 1:]}


def prompt(seed: int, index: int, length: int, vocab: int, zipf_a: float) -> np.ndarray:
    """Request ``index``'s prompt, (length,) int32."""
    raw = _rng(seed, index).zipf(zipf_a, size=length).astype(np.int64)
    return (raw % vocab).astype(np.int32)


def to_device(rows: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in rows.items()}
