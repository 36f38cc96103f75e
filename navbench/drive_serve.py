"""The ``serve`` traffic: requests through the program's ``ModelEngine``.

Set-up builds the engine (B = 1 a request, as the program serves) with the
benchmark's weights in place of its own, and serves ``warmup_requests``
requests of the mix's shapes. The window then offers requests at the
mix's fixed ``rate_per_s``, an open loop: request ``i`` is due at ``i /
rate`` seconds into the window, its prompt drawn from the seed, and is
served when it is due or, if the engine is still busy, as soon as it is
free. Its time to first token runs from when it was due to when the
prefill's argmax reached the host; then it decodes to ``max_new`` tokens.
Requests are offered while they fall due within ``--seconds``, and every
one offered is served to its end; one that has not started a minute past
the window's close (the engine far behind the rate) counts as failed.

Once the window has closed, a sample of the served requests drawn from the
seed (the longest among them) is held against the reference: its full
forward pass over each prompt and the tokens served, in float32.

A traced run profiles ``traced_requests`` more prefills after the window.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

import compare
import generator
import harness
import reference
import weights

WARMUP_INDEX = 1 << 40  # warm-up prompts' counters, apart from the window's
GRACE_S = 60.0  # a request due in the window not started this long past its close: failed


class Serve:
    def __init__(self, cell: dict, dev):
        self.cfg, self.mix, self.dev = cell["cfg"], cell["mix"], dev
        self.port = harness.port_config(self.cfg)

    def prompt(self, seed: int, i: int) -> np.ndarray:
        m = self.mix
        return generator.prompt(seed, i, m["prompt_len"], self.cfg["vocab"], m["zipf_a"])

    def engine(self, seed: int):
        """The program's engine, serving the benchmark's weights of ``seed``."""
        from repro_torch.models import Model
        from repro_torch.serve.engine import ModelEngine

        model = Model(self.port)
        weights.check_against(self.cfg, weights.flatten(model.param_specs()))
        # built at the registry's small size (its own weights are not used),
        # then given the configuration as run and the benchmark's weights
        eng = ModelEngine(self.cfg["arch"], smoke=True, seed=0, device=self.dev)
        eng.cfg, eng.model, eng.vocab = self.port, model, self.port.vocab
        eng.params = weights.nest(weights.make(self.cfg, seed, self.dev))
        return eng

    def serve(self, eng, prompt: np.ndarray) -> tuple[list[int], float, float]:
        """(the served tokens, when the prefill was called, when its first
        token reached the host)."""
        from repro_torch.serve.engine import is_done, transcript

        called = time.perf_counter()
        state = eng.prefill(prompt, self.mix["max_new"])
        first = time.perf_counter()
        while not is_done(state):
            state = eng.decode(state)
        return transcript(state), called, first

    def gaps(self, seed: int, served: list[tuple[np.ndarray, list[int]]],
             control: bool = False) -> list[float]:
        """Each served token's gap below the reference's best logit; with
        ``control``, the gap of the token the fp8 reference puts first."""
        w = weights.make(self.cfg, seed, self.dev, dtype_of=lambda p, d: torch.float32)
        out = []
        with reference.float32_products():
            for prompt, toks in served:
                seq = torch.from_numpy(np.concatenate([prompt, np.asarray(toks[:-1], np.int32)]))
                seq = seq.to(self.dev)
                pos = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(toks), device=self.dev)
                ref = reference.logits_at(w, seq, pos, self.cfg)
                if control:
                    toks = reference.logits_at(w, seq, pos, self.cfg, "fp8").argmax(-1).tolist()
                out += compare.logit_gaps(ref, toks)
                del ref
        del w
        return out


def sample(seed: int, lengths: list[int], k: int) -> list[int]:
    """``k`` of the served requests drawn from the seed, the longest
    first among them."""
    longest = int(np.argmax(lengths))
    rest = [i for i in range(len(lengths)) if i != longest]
    rng = np.random.default_rng(seed)
    return [longest] + sorted(rng.choice(rest, size=min(k - 1, len(rest)), replace=False).tolist())


def run(cell: dict, seed: int, seconds: float, traced: bool, dev, t_start: float,
        fault=None, stamps=None) -> dict:
    """One run; ``stamps`` (set-up's stages, seconds from ``t_start``)
    gains the driver's stages and goes into the result's diagnostics."""
    import devtrace

    s = Serve(cell, dev)
    mix = s.mix
    stamps = {} if stamps is None else stamps
    stamps["imported"] = time.perf_counter() - t_start
    eng = s.engine(seed)
    if fault is not None:
        eng = fault(eng)
    harness.sync(dev)
    stamps["weights"] = time.perf_counter() - t_start
    for j in range(mix["warmup_requests"]):
        _, called, first = s.serve(eng, s.prompt(seed, WARMUP_INDEX + j))
        stamps[f"warmup{j + 1}_prefill"] = first - t_start
        stamps[f"warmup{j + 1}"] = time.perf_counter() - t_start
    harness.sync(dev)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    rate, records = mix["rate_per_s"], []
    close = t0 + seconds
    offered = math.ceil(seconds * rate)  # requests due within the window
    while (due := t0 + len(records) / rate) < close:
        if time.perf_counter() > close + GRACE_S:  # the rest would never start: failed
            break
        prompt = s.prompt(seed, len(records))
        while (now := time.perf_counter()) < due:
            time.sleep(min(due - now, 0.05))
        toks, called, first = s.serve(eng, prompt)
        records.append({"prompt": prompt, "out": toks, "ttft_s": first - due,
                        "prefill_s": first - called, "served_s": time.perf_counter() - called})
    window_s = time.perf_counter() - t0
    summary = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            a = time.perf_counter()
            for j in range(mix["traced_requests"]):
                eng.prefill(s.prompt(seed, len(records) + j), mix["max_new"])
            harness.sync(dev)
            traced_s = time.perf_counter() - a
        summary = devtrace.summarize(prof, traced_s)
        del prof
    peak = harness.peak_bytes(dev)
    del eng
    harness.free(dev)
    picked = sample(seed, [len(r["prompt"]) + len(r["out"]) for r in records],
                    mix["checked_requests"])
    a = time.perf_counter()
    gaps = s.gaps(seed, [(records[i]["prompt"], records[i]["out"]) for i in picked])
    reference_s = time.perf_counter() - a
    failed = offered - len(records) + sum(len(r["out"]) != mix["max_new"] for r in records)
    return {"numbers": {"logit_gap": max(gaps),
                        "_worst": {"requests": picked, "tokens": len(gaps),
                                   "reference_s": reference_s,
                                   "ttft_s": [r["ttft_s"] for r in records],
                                   "served_s": [r["served_s"] for r in records],
                                   "setup_stamps_s": stamps}},
            "attempted": offered, "failed": failed, "memory_peak_bytes": peak,
            "end_to_end": {"ttft_p50_s": statistics.median(r["ttft_s"] for r in records),
                           "setup_s": setup_s},
            "trace": summary,
            "view": {"kind": "serve", "cfg": s.cfg, "mix": mix, "requests": len(records),
                     "window_s": window_s, "prefill_s": [r["prefill_s"] for r in records],
                     "trace": summary,
                     "traced_requests": mix["traced_requests"] if traced else 0}}
