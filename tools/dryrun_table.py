#!/usr/bin/env python3
"""A markdown table of dry-run cells (``python -m repro_torch.launch.dryrun``).

    python3 tools/dryrun_table.py experiments/dryrun_torch

One row a cell JSON in the directory, production meshes first: how the
steps compute (``tp``; ``+seq_shard`` and
``+moe_buf_shard`` after a train cell's shape, a depth cut as ``(N
layers)``), per-device FLOPs, bytes, collective bytes (of them
all-gathered; all-to-all), peak live memory and its ratio to an H100's
80 GB, or the skip reason or error.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

HBM = 80e9  # an H100's device memory, bytes


def row(rec: dict) -> str:
    shape = (rec["shape"] + (" +seq_shard" if rec.get("seq_shard") else "")
             + (" +moe_buf_shard" if rec.get("moe_buf_shard") else "")
             + (f" ({rec['layers']} layers)" if rec.get("layers") else ""))
    head = f"| {rec['arch']} | {shape} | {rec['mesh']} | {rec.get('path', '')} |"
    if "skipped" in rec:
        return head + " skipped: long_500k needs sub-quadratic attention | | | | |"
    if not rec.get("ok"):
        return head + f" FAILED: {rec.get('error', '')[:80]} | | | | |"
    coll = rec["collectives"]
    gathered = coll["by_kind"].get("all-gather", {}).get("bytes", 0.0)
    a2a = coll["by_kind"].get("all-to-all", {}).get("bytes", 0.0)
    peak = rec["memory"]["peak_memory_in_bytes"]
    return (head + f" {rec['cost']['flops']:.4g} | {rec['cost']['bytes accessed']:.4g} | "
            f"{coll['total_bytes']:.4g} ({gathered:.4g}; {a2a:.4g}) | {peak / 1e9:.2f} | "
            f"{peak / HBM:.2f} |")


def main(argv: list[str]) -> int:
    cells = [json.loads(p.read_text()) for p in sorted(Path(argv[0]).glob("*.json"))]
    order = {"16x16": 0, "2x16x16": 1}
    cells.sort(key=lambda r: (order.get(r["mesh"], 2), r["arch"], r["shape"],
                              bool(r.get("seq_shard")), bool(r.get("moe_buf_shard")),
                              r.get("layers", 0)))
    print("| arch | shape | mesh | path | FLOPs | bytes | collective bytes (all-gather; "
          "all-to-all) | peak GB | peak / 80 GB |")
    print("|---|---|---|---|---|---|---|---|---|")
    for rec in cells:
        print(row(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
