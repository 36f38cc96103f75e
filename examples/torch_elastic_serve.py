"""Serving as a preemptible job on PyTorch: the KV caches + position ARE the CMI.

An elastic fleet serves a batch of generation requests through the router
(``repro_torch.serve``): requests join a rolling batch on whichever worker
is least loaded, one is live-migrated mid-generation over the streamed
delta hop, and then the spot market SIGKILLs a worker with no notice — its
in-flight requests resume on the survivor from their last published CMI,
*without re-prefilling*.

The reference transcripts come from an unperturbed single worker in the
same fleet environment, so the final assert is bit-for-bit. Each worker
is its own process on the CUDA card, or on the host with ``--device cpu``.

    PYTHONPATH=src python examples/torch_elastic_serve.py [--device cpu]
"""

import argparse
import sys
import tempfile

sys.path.insert(0, "src")

from repro_torch.core import JobStore  # noqa: E402
from repro_torch.fabric.supervisor import FabricSupervisor  # noqa: E402
from repro_torch.serve import ServeRouter  # noqa: E402
from repro_torch.serve.scenarios import spawn_serve_worker, spot_reclaim  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    ENGINE = "model:qwen3-1.7b:smoke:seed=0"
    REQUESTS = [
        {"id": f"r{i}", "prompt": [17 + 3 * i + j for j in range(12)], "max_new": 12}
        for i in range(4)
    ]

    root = tempfile.mkdtemp(prefix="navp-serve-")
    sup = FabricSupervisor(store_root=root + "/store", jobstore_root=root + "/jobs",
                           device=args.device)
    jobstore = JobStore(root + "/jobs")

    try:
        # --- reference: one unperturbed worker defines the expected transcripts.
        ref_handle = spawn_serve_worker(sup, "ref", engine_spec=ENGINE)
        ref_router = ServeRouter(jobstore=jobstore)
        ref_router.add_worker("ref", ref_handle.address)
        for req in REQUESTS:
            ref_router.admit(req["prompt"], req["max_new"], req_id=req["id"])
        ref_router.run_to_completion()
        reference = {req["id"]: ref_router.transcript(req["id"]) for req in REQUESTS}
        ref_router.close()
        sup.reclaim("ref", notice=True)
        print(f"reference worker done: {len(reference)} transcripts recorded")

        # --- the churn run: two workers, live migration, then a spot kill -------
        router = ServeRouter(jobstore=jobstore)
        for name in ("w0", "w1"):
            handle = spawn_serve_worker(sup, name, engine_spec=ENGINE, publish_every=3)
            router.add_worker(name, handle.address)
        for req in REQUESTS:
            router.admit(req["prompt"], req["max_new"], req_id=req["id"])
        for _ in range(3):
            router.step()

        victim = next(r for r in router.pending() if router.assignment[r] == "w0")
        event = router.migrate(victim, "w1")
        assert event["mode"] == "stream", event
        print(f"live-migrated {victim} w0 -> w1 mid-generation: "
              f"{event['chunks']} chunks ({event['data_chunks']} streamed, "
              f"{event['ref_chunks']} ref'd), zero re-prefill")
        for _ in range(2):
            router.step()

        # the spot market takes w0 with NO notice: SIGKILL, no flush. Its
        # requests resume on w1 from their last published CMI.
        out = spot_reclaim(sup, router, "w0", "w1", notice=False)
        print(f"w0 SIGKILLed (rc={out['rc']}); resumed on w1: {out['resumed']}")
        router.run_to_completion()

        for req in REQUESTS:
            got = router.transcript(req["id"])
            assert got == reference[req["id"]], f"{req['id']} diverged: {got}"
        print("all transcripts identical to the unperturbed run:")
        for req in REQUESTS:
            print(f"  {req['id']}: {reference[req['id']]}")
        router.close()
    finally:
        sup.shutdown()


if __name__ == "__main__":  # the ranks and workers are spawned processes
    main()
