"""Serving CLI: continuous batching over repro_torch.serve, in-process or fabric.

Port of the JAX package's ``repro/launch/serve.py``. The same
:class:`~repro_torch.serve.worker.ServeHost` loop answers every mode, so the
printed transcripts are a pure function of ``(--arch/--seed, --prompt-len,
--gen, --batch)`` on one machine — identical whether the batch runs in this
process (``--workers 0``) or is spread over N serving worker processes
(``repro_torch.serve.worker``) under a router, on either transport:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --workers 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b --layers 4

The model runs on the CUDA card unless ``--device cpu`` is given, in this
process or in every worker; asking for the card where there is none raises
(a worker exits non-zero before it serves). Reports per-phase throughput:
prefill tok/s (prompt tokens / prefill wall time) and decode tok/s
(generated tokens past the first / decode wall time), plus TTFT p50/max
when routing over workers. ``--layers N`` cuts the model's depth to N
layers, widths kept (deepseek-v3-671b at 4: its 3 dense layers and one
MoE layer); the engine spec carries the cut (``model:<arch>:full:layers=4:
seed=0``), so every worker builds the same weights. ``main`` returns the
metrics dict.
"""

from __future__ import annotations

import argparse
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

from repro_torch.utils import logger, resolve_device


def build_requests(vocab: int, *, batch: int, prompt_len: int, gen: int,
                   seed: int) -> list[dict]:
    """Seed-deterministic request set (the CLI's whole input surface)."""
    rng = np.random.default_rng(seed)
    return [
        {"id": f"r{i:03d}",
         "prompt": [int(t) for t in rng.integers(0, vocab, prompt_len)],
         "max_new": int(gen)}
        for i in range(batch)
    ]


def _engine_spec(args) -> tuple[str, int]:
    """CLI flags -> (engine spec string, vocab for prompt sampling)."""
    if args.arch:
        from repro_torch.configs import get_config, get_smoke_config

        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
        mode = "smoke" if args.smoke else "full"
        cut = f":layers={args.layers}" if args.layers else ""
        return f"model:{args.arch}:{mode}{cut}:seed={args.seed}", cfg.vocab
    return f"toy:seed={args.seed}", 512


def run_local(spec: str, requests: list[dict], device: torch.device) -> dict:
    """One ServeHost in this process, no fabric at all."""
    from repro_torch.serve.engine import make_engine
    from repro_torch.serve.worker import ServeHost

    host = ServeHost(make_engine(spec, device=device))
    transcripts: dict[str, list[int]] = {}
    prefill_s = 0.0
    for req in requests:
        res = host.admit(req["id"], req["prompt"], req["max_new"])
        prefill_s += res["prefill_s"]
        transcripts[req["id"]] = [tok for _, tok in res["tokens"]]
    t1 = time.perf_counter()
    decoded = 0
    while host.active:
        for req_id, toks in host.step()["tokens"].items():
            transcripts[req_id].extend(tok for _, tok in toks)
            decoded += len(toks)
    decode_s = time.perf_counter() - t1
    return {
        "mode": "local",
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "decoded": decoded,
        "transcripts": transcripts,
    }


def run_routed(spec: str, requests: list[dict], *, workers: int, transport: str,
               publish_every: int, device: str) -> dict:
    """``--workers N``: real serving worker processes on ``device`` + the
    router, either wire."""
    from repro_torch.core.jobstore import JobStore
    from repro_torch.fabric.supervisor import FabricSupervisor
    from repro_torch.serve.router import ServeRouter
    from repro_torch.serve.scenarios import spawn_serve_worker

    root = tempfile.mkdtemp(prefix="navp-serve-cli-")
    sup = FabricSupervisor(store_root=root + "/store", jobstore_root=root + "/jobs",
                           transport=transport, device=device)
    router = ServeRouter(jobstore=JobStore(root + "/jobs"))
    try:
        for i in range(workers):
            handle = spawn_serve_worker(sup, f"s{i}", engine_spec=spec,
                                        publish_every=publish_every)
            router.add_worker(f"s{i}", handle.address)
        t0 = time.perf_counter()
        for req in requests:
            router.admit(req["prompt"], req["max_new"], req_id=req["id"])
        prefill_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        router.run_to_completion()
        decode_s = time.perf_counter() - t1
        transcripts = {req["id"]: router.transcript(req["id"])
                       for req in requests}
        ttft = list(router.ttft_s.values())
        return {
            "mode": f"routed:{workers}x{transport}",
            "prefill_s": prefill_s,
            "decode_s": decode_s,
            "decoded": sum(len(t) - 1 for t in transcripts.values()),
            "transcripts": transcripts,
            "ttft_p50_s": statistics.median(ttft),
            "ttft_max_s": max(ttft),
        }
    finally:
        router.close()
        sup.shutdown()
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="continuous-batching serving CLI over repro_torch.serve")
    ap.add_argument("--arch", default="",
                    help="model arch (empty: deterministic toy engine)")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke-sized model config (with --arch)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model's depth to this many layers (0: keep it); widths stay")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default: the CUDA card)")
    ap.add_argument("--workers", type=int, default=0,
                    help="serving worker processes (0 = in-process host)")
    ap.add_argument("--transport", choices=("unix", "tcp"), default="unix")
    ap.add_argument("--publish-every", type=int, default=8,
                    help="CMI publish cadence in decode steps (workers mode)")
    args = ap.parse_args(argv)

    spec, vocab = _engine_spec(args)
    requests = build_requests(vocab, batch=args.batch,
                              prompt_len=args.prompt_len, gen=args.gen,
                              seed=args.seed)
    if args.workers > 0:
        metrics = run_routed(spec, requests, workers=args.workers,
                             transport=args.transport,
                             publish_every=args.publish_every, device=args.device)
    else:
        metrics = run_local(spec, requests, resolve_device(args.device))

    prompt_toks = args.batch * args.prompt_len
    decode_toks = metrics["decoded"]
    metrics["prefill_tok_s"] = prompt_toks / max(metrics["prefill_s"], 1e-9)
    metrics["decode_tok_s"] = decode_toks / max(metrics["decode_s"], 1e-9)
    logger.info(
        "%s: prefill %d tok in %.3fs (%.1f tok/s); decode %d tok in %.3fs (%.1f tok/s)",
        metrics["mode"], prompt_toks, metrics["prefill_s"],
        metrics["prefill_tok_s"], decode_toks, metrics["decode_s"],
        metrics["decode_tok_s"],
    )
    if "ttft_p50_s" in metrics:
        logger.info("TTFT p50 %.1fms max %.1fms",
                    metrics["ttft_p50_s"] * 1e3, metrics["ttft_max_s"] * 1e3)
    for req in requests:
        print(f"{req['id']}: {metrics['transcripts'][req['id']]}")
    return metrics


if __name__ == "__main__":
    main()
