"""The ``train`` traffic: a closed loop of the program's training steps.

Set-up builds one train state (the program's own layout, ``state_specs``,
holding the benchmark's weights and their float32 master copy: the
program's ``make_init_fn`` would draw weights only to have them
overwritten), one ``make_train_step`` step, and drives that step through the
mix's first ``checked_steps`` steps on rows that all differ: they warm up
every shape and are what the reference checks. After the first, each
leaf's clipped gradient is read from the first moment (``mu / (1 - b1)``);
after the last, each leaf's change from the starting weights. The window
then runs steps back to back on further rows, each starting when the last
ended, for ``--seconds``; the last ends in a ``synchronize``.
``train_tok_s`` is every token of those steps over the window's time.

Once the window has closed and the peak memory is read, the program's
state is freed and the reference follows the same first steps from the
same weights on the same rows (``reference.train``).

A traced run profiles ``traced_steps`` more steps after the window.
"""

from __future__ import annotations

import math
import time

import torch

import compare
import generator
import harness
import reference
import weights


class Train:
    def __init__(self, cell: dict, dev):
        from repro_torch.distributed.steps import make_train_step
        from repro_torch.optim import AdamWConfig

        self.cfg, self.mix, self.dev = cell["cfg"], cell["mix"], dev
        self.port = harness.port_config(self.cfg)
        self.opt_cfg = AdamWConfig(**self.mix["optimizer"],
                                   moment_dtype=self.cfg["opt_moment_dtype"])
        self.make_step = lambda: make_train_step(
            self.port, self.opt_cfg, peak_lr=self.mix["peak_lr"], warmup=self.mix["warmup"],
            total_steps=self.mix["total_steps"])

    def rows(self, seed: int, step: int) -> dict:
        m = self.mix
        return generator.to_device(generator.train_batch(
            seed, step, m["batch"], m["seq_len"], self.cfg["vocab"], m["zipf_a"]), self.dev)

    def state(self, seed: int) -> dict:
        """The program's train state with the benchmark's weights of
        ``seed``: every leaf of the program's own layout (``state_specs``,
        nothing drawn), the parameters the weights, the float32 master their
        copy, the moments and counters zero and ``rng`` as ``make_init_fn``
        sets it (seed 0)."""
        from repro_torch.distributed.steps import state_specs

        specs = weights.flatten(state_specs(self.port, self.opt_cfg))
        weights.check_against(self.cfg, {p[len("params/"):]: s for p, s in specs.items()
                                         if p.startswith("params/")})
        w = weights.make(self.cfg, seed, self.dev)
        flat = {}
        for path, spec in specs.items():
            head, _, leaf = path.partition("/")
            if head == "params":
                t = w[leaf]
            elif path.startswith("opt/master/"):
                t = w[path[len("opt/master/"):]].float()
            elif path == "rng":
                t = torch.tensor([0, 1], dtype=spec.dtype, device=self.dev)
            else:
                t = torch.zeros(spec.shape, dtype=spec.dtype, device=self.dev)
            if tuple(t.shape) != tuple(spec.shape) or t.dtype != spec.dtype:
                raise ValueError(f"{path}: {tuple(t.shape)} {t.dtype}, the program's {spec}")
            flat[path] = t
        return weights.nest(flat)

    def first_steps(self, seed: int, fault=None, stamps=None, t_start: float = 0.0):
        """``(state, step, numbers)``: the state driven through the checked
        steps by ``step``, and what they produced (losses, first gradient's
        and change's leaf norms). ``fault`` breaks the step (tests);
        ``stamps`` gets the seconds from ``t_start`` to each stage."""
        stamps = {} if stamps is None else stamps
        state, step = self.state(seed), self.make_step()
        harness.sync(self.dev)
        stamps["weights"] = time.perf_counter() - t_start
        if fault is not None:
            step = fault(step)
        b1 = self.opt_cfg.b1
        losses, grad_norms = [], None
        for i in range(self.mix["checked_steps"]):
            state, m = step(state, self.rows(seed, i))
            losses.append(m["loss"])
            if i == 0:
                mu = reference.leaf_norms(weights.flatten(state["opt"]["mu"]))
                grad_norms = {p: n / (1 - b1) for p, n in mu.items()}
            harness.sync(self.dev)
            stamps[f"step{i + 1}"] = time.perf_counter() - t_start
        w0 = weights.make(self.cfg, seed, self.dev)
        master = weights.flatten(state["opt"]["master"])
        change = reference.leaf_norms({p: master[p] - w0[p].float() for p in w0})
        del w0
        stamps["change"] = time.perf_counter() - t_start
        numbers = {"losses": [float(v) for v in losses], "grad_norms": grad_norms,
                   "change_norms": change}
        return state, step, numbers

    def reference(self, seed: int, prec: str = "fp32") -> dict:
        w0 = weights.make(self.cfg, seed, self.dev, dtype_of=lambda p, d: torch.float32)
        rows = [self.rows(seed, i) for i in range(self.mix["checked_steps"])]
        opt = {**self.mix["optimizer"], **{k: self.mix[k] for k in
                                           ("peak_lr", "warmup", "total_steps")}}
        with reference.float32_products():
            return reference.train(w0, rows, self.cfg, opt, prec)


def run(cell: dict, seed: int, seconds: float, traced: bool, dev, t_start: float,
        fault=None, stamps=None) -> dict:
    """One run; ``stamps`` (set-up's stages, seconds from ``t_start``)
    gains the driver's stages and goes into the result's diagnostics."""
    import devtrace

    t = Train(cell, dev)
    mix = t.mix
    stamps = {} if stamps is None else stamps
    stamps["imported"] = time.perf_counter() - t_start
    state, step, prog = t.first_steps(seed, fault, stamps, t_start)
    harness.sync(dev)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    i, losses = mix["checked_steps"], []
    while True:
        state, m = step(state, t.rows(seed, i))
        losses.append(m["loss"])
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    harness.sync(dev)
    window_s = time.perf_counter() - t0
    steps = len(losses)
    summary = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            a = time.perf_counter()
            for _ in range(mix["traced_steps"]):
                state, _ = step(state, t.rows(seed, i))
                i += 1
            harness.sync(dev)
            traced_s = time.perf_counter() - a
        summary = devtrace.summarize(prof, traced_s)
        del prof
    failed = sum(not math.isfinite(v) for v in torch.stack(losses).tolist())
    peak = harness.peak_bytes(dev)
    del state, step, m
    harness.free(dev)
    a = time.perf_counter()
    ref = t.reference(seed)
    harness.free(dev)
    numbers = compare.train_numbers(prog, ref)
    numbers["_worst"]["reference_s"] = time.perf_counter() - a
    numbers["_worst"]["setup_stamps_s"] = stamps
    tokens = mix["batch"] * mix["seq_len"]
    return {"numbers": numbers, "attempted": steps, "failed": failed, "memory_peak_bytes": peak,
            "end_to_end": {"train_tok_s": steps * tokens / window_s, "setup_s": setup_s},
            "trace": summary,
            "view": {"kind": "train", "cfg": t.cfg, "mix": mix, "steps": steps,
                     "window_s": window_s, "trace": summary,
                     "traced_steps": mix["traced_steps"] if traced else 0}}
