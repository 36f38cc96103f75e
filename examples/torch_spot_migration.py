"""Elastic spot migration on PyTorch: lose half the cluster mid-training, keep going.

Part 1 — a training job starts on a 4×2 (data×model) mesh, one process a
rank (gloo ranks on the host with ``--device cpu``, one card a rank with
``cuda``). At step 12 the spot market reclaims the instance; the
replacement is SMALLER — a 2×2 mesh. The CMI's sharding records remap by
axis name, so the same job resumes on the new topology without any user
code (``launch.train --remesh 4x2,2x2``).

Part 2 — the process fabric makes the reclaim REAL: a worker runs in its own
OS process and the supervisor kills it with SIGKILL (a no-notice spot
reclaim) mid-job. A fresh process restores from the last published CMI and
finishes the job; the jobstore on the shared filesystem is the only medium
the two incarnations ever share.

    PYTHONPATH=src python examples/torch_spot_migration.py --device cpu
    PYTHONPATH=src python examples/torch_spot_migration.py    # 8 cards, then 4
"""

import argparse
import sys
import tempfile

sys.path.insert(0, "src")

import repro_torch.launch.train as train  # noqa: E402
from repro_torch.core.jobstore import STATUS_FINISHED, JobStore  # noqa: E402
from repro_torch.core.preemption import SpotSchedule  # noqa: E402
from repro_torch.fabric.supervisor import FabricSupervisor  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    store = tempfile.mkdtemp(prefix="navp-elastic-")
    loss = train.main([
        "--arch", "granite-moe-1b-a400m", "--smoke", "--device", args.device,
        "--steps", "24", "--publish-every", "6",
        "--preempt-at", "12",
        "--remesh", "4x2,2x2",  # incarnation 0: 8 ranks; incarnation 1: 4 ranks
        "--store", store,
        "--seq-len", "64", "--batch", "8",
    ])
    print(f"\nfinal loss after elastic 8→4 rank migration: {loss:.4f}")

    # -- Part 2: process-per-node fabric, SIGKILL reclaim ------------------------
    fab_store = tempfile.mkdtemp(prefix="navp-fabric-")
    job_root = tempfile.mkdtemp(prefix="navp-fabric-jobs-")
    jobstore = JobStore(job_root)
    job = jobstore.create_job({"seed": 11, "n": 4096, "steps": 40, "publish_every": 8})
    with FabricSupervisor(fab_store, job_root, device=args.device) as sup:
        out = sup.run_job(
            job.job_id,
            schedule=SpotSchedule(preempt_steps=(16,), max_preemptions=1),
            notice=False,  # SIGKILL: no 2-minute warning, the process just dies
            steps=40, publish_every=8, step_ms=20, timeout_s=300,
        )
    finished = jobstore.wait_for_status(job.job_id, STATUS_FINISHED, timeout_s=10)
    print(
        f"fabric job {job.job_id}: {finished.status} at step {finished.step} "
        f"after {out['reclaims']} SIGKILL reclaim(s), "
        f"{out['incarnations']} worker process(es); product={finished.product}"
    )
    assert finished.status == STATUS_FINISHED and out["reclaims"] == 1, out
    print("spot migration: both jobs finished")


if __name__ == "__main__":  # the ranks and workers are spawned processes
    main()
