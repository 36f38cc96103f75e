#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 navbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in ``BENCHMARK.json`` names
its configuration and traffic mix (``harness.py``); the mix's ``kind``
picks the driver (``drive_train.py``, ``drive_serve.py``). The run makes
its weights and inputs from ``--seed``, warms up (counted in ``setup_s``),
measures for ``--seconds``, then checks what the timed path produced
against the plain reference (``reference.py``, ``compare.py``). With
``--trace 0`` the result's metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics (``metrics/<name>.py``), read from a
``torch.profiler`` trace of further steps or prefills after the window.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each compared number with its limit
(also the last lines of standard error). Without a CUDA card, with fewer
cards than the cell asks for, or with JAX or the JAX package loaded, it
prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
CACHE = CHECKOUT / "build" / "navbench-cache"  # fixed paths inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
# Python's bytecode of every module it imports, torch's too: where the
# installation's own cache is absent or not writable, each run would compile
# some 1,600 modules from source again (about 10 s of the host's time).
sys.pycache_prefix = str(CACHE / "pycache")
sys.dont_write_bytecode = False
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [str(HERE), str(CHECKOUT / "src")]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def per_layer(cell: dict, view: dict) -> dict:
    import harness

    out = {}
    for m in cell["per_layer"]:
        value = harness.metric_reader(m["name"])(view)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(cell: dict, got: dict, traced: bool, torch) -> tuple[dict, dict]:
    import compare
    import devtrace

    correct, checks = compare.judge(got["numbers"], cell["limits"])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": got["memory_peak_bytes"]}
    out = {"correct": correct, "attempted": got["attempted"], "failed": got["failed"]}
    if traced:
        summary = got["trace"]
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        out["metrics"] = per_layer(cell, got["view"])
        out["device"] = device
        out["breakdown"] = {"device_ops": devtrace.top_ops(summary),
                            "idle_gaps": summary["idle_gaps"]}
    else:
        e2e = got["end_to_end"]
        # a metric named "<quantity>.<suffix>" is the driver's <quantity> in
        # the cells it lists (one bound a kind of cell)
        out["metrics"] = {m["name"]: {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}
                          for m in cell["end_to_end"]}
        out["device"] = device
    return out, checks


def main(argv=None) -> int:
    args = parse(argv)
    import harness

    cell = harness.cell(harness.load_benchmark(CHECKOUT), args.workload)
    import torch

    stamps = {"torch": time.perf_counter() - T_START}
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"navbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    dev = torch.device("cuda", 0)
    torch.empty(1, device=dev)  # the CUDA context
    torch.cuda.synchronize(dev)
    stamps["cuda"] = time.perf_counter() - T_START
    kind = cell["mix"]["kind"]
    driver = importlib.import_module(f"drive_{kind}").run  # only the cell's own driver
    got = driver(cell, args.seed, args.seconds, bool(args.trace), dev, T_START,
                 stamps=stamps)
    print(f"navbench: {args.workload} seed {args.seed}: {got['end_to_end']}, "
          f"{got['attempted']} attempted, peak {got['memory_peak_bytes']} bytes; "
          f"compared {got['numbers']}", file=sys.stderr)
    out, checks = result(cell, got, bool(args.trace), torch)
    import guard
    import reference

    bad = guard.loaded_forbidden() + [f"reference imports {m}"
                                      for m in guard.reference_imports(reference)]
    if bad:
        print(f"navbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    harness.emit(out, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
