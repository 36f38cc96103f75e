"""Faults planted under a run's timed path, for the tests and the limits'
readings: each must turn ``correct`` false.

* :func:`unchanged`: a training step that returns its state unchanged;
* :func:`half_batch`: a training step that leaves out half of the batch,
  its mean taken over the rest;
* :func:`altered_token`: a served token altered where it is produced.
"""

from __future__ import annotations

import torch

import weights


def unchanged(step):
    def broken(state, batch):
        flat = {k: t for k, t in weights.flatten(state).items() if torch.is_tensor(t)}
        saved = {k: t.clone() for k, t in flat.items()}
        state, metrics = step(state, batch)
        with torch.no_grad():
            for k, t in flat.items():
                t.copy_(saved[k])
        return state, metrics
    return broken


def half_batch(step):
    def broken(state, batch):
        return step(state, {k: v[:max(1, v.shape[0] // 2)] for k, v in batch.items()})
    return broken


def altered_token(eng):
    decode = eng.decode

    def broken(state):
        state = decode(state)
        d = int(state["done"]) - 1
        state["out"][d] = (int(state["out"][d]) + 1) % eng.vocab
        state["tok"] = int(state["out"][d])
        return state

    eng.decode = broken
    return eng


BY_NAME = {"unchanged": unchanged, "half_batch": half_batch, "altered_token": altered_token}
