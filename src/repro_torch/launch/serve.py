"""Serving CLI: continuous batching over repro_torch.serve, in process.

Port of the JAX package's ``repro/launch/serve.py``. One
:class:`~repro_torch.serve.worker.ServeHost` answers the requests, so the
printed transcripts are a pure function of ``(--arch/--seed, --prompt-len,
--gen, --batch)`` on one machine:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke --device cpu

The model runs on the CUDA card unless ``--device cpu`` is given; asking
for the card where there is none raises. Reports per-phase throughput:
prefill tok/s (prompt tokens / prefill wall time) and decode tok/s
(generated tokens past the first / decode wall time). ``main`` returns the
metrics dict. Routing over serving workers (``--workers N``) comes with
the serving fleet, which is not ported yet (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

import argparse
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
        return f"model:{args.arch}:{mode}:seed={args.seed}", cfg.vocab
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.serve",
        description="continuous-batching serving CLI over repro_torch.serve")
    ap.add_argument("--arch", default="",
                    help="model arch (empty: deterministic toy engine)")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke-sized model config (with --arch)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default: the CUDA card)")
    ap.add_argument("--workers", type=int, default=0,
                    help="fabric worker processes (0 = in-process host)")
    args = ap.parse_args(argv)

    if args.workers > 0:
        raise NotImplementedError(
            "--workers > 0 routes over serving workers, which are not ported yet "
            "(ROADMAP queue 1, item 10)")
    device = resolve_device(args.device)
    spec, vocab = _engine_spec(args)
    requests = build_requests(vocab, batch=args.batch,
                              prompt_len=args.prompt_len, gen=args.gen,
                              seed=args.seed)
    metrics = run_local(spec, requests, device)

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
    for req in requests:
        print(f"{req['id']}: {metrics['transcripts'][req['id']]}")
    return metrics


if __name__ == "__main__":
    main()
