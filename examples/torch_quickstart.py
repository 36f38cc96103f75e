"""Quickstart on PyTorch: train a model with application-initiated checkpointing.

The paper's Figure-7 flow through ``repro_torch``: create a job, train,
publish CMIs at application-chosen points, kill it, resume, finish.

    PYTHONPATH=src python examples/torch_quickstart.py               # on the CUDA card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse
import sys
import tempfile

sys.path.insert(0, "src")

import repro_torch.launch.train as train  # noqa: E402
from repro_torch.core.jobstore import STATUS_FINISHED, JobStore  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    store = tempfile.mkdtemp(prefix="navp-quickstart-")

    # Run 1: train to step 30, but a (simulated) spot reclaim lands at step 17.
    # The worker publishes a CMI and exits; the supervisor provisions a fresh
    # "instance" and resumes from the job store — the same losses as an
    # uninterrupted run (tested bitwise in tests/test_torch_train.py).
    loss = train.main([
        "--arch", "qwen3-1.7b", "--smoke", "--device", args.device,
        "--steps", "30", "--publish-every", "10",
        "--preempt-at", "17",
        "--store", store,
        "--seq-len", "64", "--batch", "8",
    ])
    print(f"\nfinal loss: {loss:.4f}")
    print(f"job store: {store}")
    jobs = JobStore(store).svc_list_jobs()
    print("jobs:", jobs)  # [['1', 'finished']]
    assert [status for _, status in jobs] == [STATUS_FINISHED], jobs
    print("quickstart: job finished after a reclaim at step 17")


if __name__ == "__main__":  # the ranks and workers are spawned processes
    main()
