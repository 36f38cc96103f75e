"""Generation engines: the per-request decode state IS the CMI.

A serving engine owns model parameters (shared, immutable, re-derivable from
a seed in any process) and produces **per-request** state dicts that are the
unit of everything the serve layer does: decode, publish, migrate, resume.
One request = one state = one CMI — the paper's application-chosen
checkpoint, specialized to "KV cache + position".

Every state dict has the same shape regardless of engine::

    {"kv" | "caches": <cache arrays, preallocated at s_total>,
     "out":    int32 (max_new,)   # generated tokens, slot-filled
     "prompt": int32 (prompt_len,)
     "pos": int,    # absolute position the NEXT decode step writes
     "done": int,   # generated tokens so far (>= 1 after prefill)
     "tok": int,    # last generated token (input to the next step)
     "step": int}   # display step == done (svc/hop's _derive_step convention)

Two properties the serve layer relies on:

* **Append-only cache growth.** Caches are preallocated at the full
  ``prompt_len + max_new`` extent and decode writes exactly one new row
  (toy) / position (model) per step, in place. Earlier bytes never change,
  so a delta hop after k steps ships only the chunks those k rows landed in
  (the JAX package's tests/test_serve.py asserts the on-the-wire chunk count).
* **Batch-composition independence.** Each request decodes against its own
  state — there is no cross-request tensor batching — so a transcript is a
  pure function of (engine seed, prompt, max_new). That is what makes the
  bit-identical-transcript invariant checkable across migration, resume,
  and worker-count permutations.

``ToyEngine`` is numpy float64 with elementwise-only arithmetic (no BLAS
reductions), so transcripts are bit-stable across *processes* — the same
discipline as the fabric worker's demo job. It is a copy of the JAX
package's (``repro/serve/engine.py``), so both packages give the same
transcripts bit for bit. ``ModelEngine`` wraps the port's
:class:`~repro_torch.models.Model` prefill/decode pair with per-request B=1
caches on a torch device (greedy argmax, deterministic on one machine and
PyTorch build); its prefill runs K3.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import spans
from repro_torch.utils import resolve_device


def is_done(state: dict) -> bool:
    return int(state["done"]) >= int(state["out"].shape[0])


def transcript(state: dict) -> list[int]:
    out = np.asarray(state["out"])
    return [int(t) for t in out[: int(state["done"])]]


class ToyEngine:
    """Deterministic numpy "language model" with a real KV-cache shape.

    The recurrence mixes the previous cache row (rolled, so information
    propagates across dimensions without a matmul) with a token embedding;
    logits read the CURRENT row blended with the running mean of every
    cache row so far. The mean makes each token depend on the *entire*
    cache — a migration that tore or skipped any chunk corrupts the
    transcript instead of passing silently.
    """

    kind = "toy"

    def __init__(self, d: int = 64, vocab: int = 512, seed: int = 0):
        self.d, self.vocab, self.seed = int(d), int(vocab), int(seed)
        rng = np.random.default_rng(self.seed)
        self.emb = rng.standard_normal((self.vocab, self.d))
        # independent output embedding: scoring against the same table that
        # wrote the row makes argmax self-reinforce into a constant stream
        self.out_emb = rng.standard_normal((self.vocab, self.d))
        self.decay = 0.5 + 0.4 * rng.random(self.d)

    def spec(self) -> str:
        return f"toy:d={self.d},vocab={self.vocab},seed={self.seed}"

    def _row(self, prev: np.ndarray, tok: int) -> np.ndarray:
        return np.tanh(np.roll(prev, 1) * self.decay + self.emb[int(tok)])

    def _next_tok(self, kv: np.ndarray, pos: int) -> int:
        # read the whole cache: elementwise product + pairwise np.sum only
        # (no BLAS), so the argmax is bit-stable across processes
        ctx = kv[: pos + 1].mean(axis=0)
        mix = 0.8 * kv[pos] + 0.2 * ctx
        logits = (self.out_emb * mix).sum(axis=1)
        return int(np.argmax(logits))

    def prefill(self, prompt, max_new: int) -> dict:
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        p, m = int(prompt.size), int(max_new)
        kv = np.zeros((p + m, self.d), dtype=np.float64)
        row = np.zeros(self.d, dtype=np.float64)
        for j, tok in enumerate(prompt):
            row = self._row(row, int(tok))
            kv[j] = row
        out = np.zeros(m, dtype=np.int32)
        out[0] = first = self._next_tok(kv, p - 1)
        return {"kv": kv, "out": out, "prompt": prompt,
                "pos": p, "done": 1, "tok": first, "step": 1}

    def decode(self, state: dict) -> dict:
        if is_done(state):
            return state
        kv = np.asarray(state["kv"])
        out = np.asarray(state["out"])
        pos, done = int(state["pos"]), int(state["done"])
        kv[pos] = self._row(kv[pos - 1], int(state["tok"]))
        tok = self._next_tok(kv, pos)
        out[done] = tok
        state.update(kv=kv, out=out, pos=pos + 1, done=done + 1,
                     tok=tok, step=done + 1)
        return state


class ModelEngine:
    """Per-request B=1 serving over the port's :class:`~repro_torch.models.Model`.

    Parameters are drawn from ``torch.Generator(device).manual_seed(seed)``
    in every process that builds the same spec on the same kind of device,
    so a migrated/resumed request decodes against identical weights without
    the weights ever traveling — only the per-request caches move (they are
    the CMI; the params are the "restart script" every instance already
    has). ``device`` defaults to the CUDA card. ``layers`` cuts the
    configuration's depth to that many layers (0 keeps it), widths kept;
    the spec carries it, so every process that builds the spec serves the
    same cut.
    """

    kind = "model"

    def __init__(self, arch: str, smoke: bool = True, seed: int = 0, device=None,
                 layers: int = 0):
        from repro_torch.configs import get_config, get_smoke_config
        from repro_torch.models import Model

        self.arch, self.smoke, self.seed, self.layers = arch, bool(smoke), int(seed), int(layers)
        self.device = resolve_device(device)
        self.cfg = get_smoke_config(arch) if smoke else get_config(arch)
        if self.layers:
            self.cfg = self.cfg.with_(n_layers=self.layers)
        if self.cfg.vision_prefix or self.cfg.encdec:
            raise ValueError(f"serving supports decoder-only archs, not {arch!r}")
        self.model = Model(self.cfg)
        self.params = self.model.init(torch.Generator(device=self.device).manual_seed(self.seed))
        self.vocab = self.cfg.vocab

    def spec(self) -> str:
        cut = f":layers={self.layers}" if self.layers else ""
        return f"model:{self.arch}:{'smoke' if self.smoke else 'full'}{cut}:seed={self.seed}"

    @spans.span("prefill")
    def prefill(self, prompt, max_new: int) -> dict:
        """The request's state after its prompt, the first token read back
        to the host: all of it the span ``prefill``."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        p, m = int(prompt.size), int(max_new)
        tokens = torch.from_numpy(prompt[None, :].astype(np.int64)).to(self.device)
        logits, caches = self.model.prefill(self.params, {"tokens": tokens}, s_max=p + m)
        out = np.zeros(m, dtype=np.int32)
        out[0] = first = int(torch.argmax(logits[0]))
        return {"caches": caches, "out": out, "prompt": prompt,
                "pos": p, "done": 1, "tok": first, "step": 1}

    def decode(self, state: dict) -> dict:
        if is_done(state):
            return state
        pos, done = int(state["pos"]), int(state["done"])
        tok_in = torch.tensor([[int(state["tok"])]], dtype=torch.int64, device=self.device)
        lg, caches = self.model.decode(self.params, state["caches"], tok_in, pos)
        tok = int(torch.argmax(lg[0, -1]))
        out = np.asarray(state["out"])
        out[done] = tok
        state.update(caches=caches, out=out, pos=pos + 1, done=done + 1,
                     tok=tok, step=done + 1)
        return state


def make_engine(spec: str, device=None) -> Any:
    """Build an engine from a CLI spec string (``device`` places a model
    engine; the CUDA card by default).

    ``toy`` / ``toy:d=64,vocab=512,seed=0`` /
    ``model:<arch>`` / ``model:<arch>:smoke|full`` /
    ``model:<arch>:smoke:seed=1`` / ``model:<arch>:full:layers=4:seed=0``
    (``layers=N``: the depth cut to N layers, widths kept)
    """
    parts = spec.split(":")
    kind = parts[0]
    if kind == "toy":
        kw: dict[str, int] = {}
        for part in parts[1:]:
            for item in part.split(","):
                if not item:
                    continue
                k, _, v = item.partition("=")
                kw[k.strip()] = int(v)
        return ToyEngine(**kw)
    if kind == "model":
        if len(parts) < 2:
            raise ValueError("model spec needs an arch: model:<arch>[:smoke|full][:seed=N]")
        arch = parts[1]
        smoke = True
        seed = layers = 0
        for part in parts[2:]:
            if part in ("smoke", "full"):
                smoke = part == "smoke"
            elif part.startswith("seed="):
                seed = int(part[5:])
            elif part.startswith("layers="):
                layers = int(part[7:])
        return ModelEngine(arch, smoke=smoke, seed=seed, device=device, layers=layers)
    raise ValueError(f"unknown engine spec {spec!r}")


def run_reference(engine, requests: list[dict]) -> dict[str, list[int]]:
    """Unperturbed per-request generation: the bit-identity oracle.

    ``requests`` entries are ``{"id", "prompt", "max_new"}``. Because
    engines are batch-composition independent, this sequential loop defines
    the transcript every fabric run — migrated, resumed, rebalanced — must
    reproduce byte for byte.
    """
    out: dict[str, list[int]] = {}
    for req in requests:
        state = engine.prefill(req["prompt"], int(req["max_new"]))
        while not is_done(state):
            state = engine.decode(state)
        out[str(req["id"])] = transcript(state)
    return out
