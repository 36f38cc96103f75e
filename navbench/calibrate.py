#!/usr/bin/env python3
"""The readings the limits are set from (``limits/<cell>.json``), in one
process: the program's numbers on each of ``--seeds``, the control's (the
reference in fp8, ``reference.py``) and each ``--faults`` fault's on
``--control-seeds``. One JSON line a reading on standard output.

    python3 navbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 [--faults half_batch]

The program's first steps (training) or served requests (serving) are
those of a run, at the cell's sizes, without the measured window.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]
os.environ["USE_FLAX"] = "0"


def line(**fields) -> None:
    print(json.dumps(fields, default=str), flush=True)


def train(cell, dev, seeds, control_seeds, fault_names):
    import compare
    import drive_train
    import faults
    import harness

    t = drive_train.Train(cell, dev)
    refs = {}
    for seed in dict.fromkeys(seeds + control_seeds):  # (--seeds may be empty)
        a = time.perf_counter()
        state, step, prog = t.first_steps(seed)
        del state, step
        harness.free(dev)
        b = time.perf_counter()
        refs[seed] = ref = t.reference(seed)
        harness.free(dev)
        line(side="program", seed=seed, **compare.train_numbers(prog, ref), prog=prog, ref=ref,
             program_s=b - a, reference_s=time.perf_counter() - b)
    for seed in control_seeds:
        ctl = t.reference(seed, "fp8")
        harness.free(dev)
        line(side="control", seed=seed, **compare.train_numbers(ctl, refs[seed]), prog=ctl,
             ref=refs[seed])
        for name in fault_names:
            state, step, prog = t.first_steps(seed, faults.BY_NAME[name])
            del state, step
            harness.free(dev)
            line(side=f"fault {name}", seed=seed, **compare.train_numbers(prog, refs[seed]),
                 prog=prog, ref=refs[seed])


def serve(cell, dev, seeds, control_seeds, fault_names):
    import drive_serve
    import faults
    import harness

    s = drive_serve.Serve(cell, dev)
    k = s.mix["checked_requests"]
    for seed in dict.fromkeys(seeds + control_seeds):
        runs = [("program", None)] + ([(f"fault {n}", faults.BY_NAME[n]) for n in fault_names]
                                      if seed in control_seeds else [])
        for side, fault in runs:
            eng = s.engine(seed)
            eng = fault(eng) if fault else eng
            s.serve(eng, s.prompt(seed, drive_serve.WARMUP_INDEX))
            served, ttft = [], []
            for i in range(k):
                prompt = s.prompt(seed, i)
                toks, called, first = s.serve(eng, prompt)
                served.append((prompt, toks))
                ttft.append(first - called)
            del eng
            harness.free(dev)
            gaps = s.gaps(seed, served)
            line(side=side, seed=seed, logit_gap=max(gaps), tokens=len(gaps), prefill_s=ttft)
            if side == "program" and seed in control_seeds:
                ctl = s.gaps(seed, served, control=True)
                line(side="control", seed=seed, logit_gap=max(ctl), tokens=len(ctl))
            harness.free(dev)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import harness
    import torch

    cell = harness.cell(harness.load_benchmark(), args.workload)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    names = [n for n in args.faults.split(",") if n]
    dev = torch.device(args.device)
    kind = {"train": train, "serve": serve}[cell["mix"]["kind"]]
    kind(cell, dev, ints(args.seeds), ints(args.control_seeds), names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
