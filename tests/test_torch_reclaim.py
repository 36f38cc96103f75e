"""A mesh incarnation's supervision on gloo ranks (CPU): the progress
timeout and the reclaim notice.

* ``run_ranks`` ends a run that goes ``timeout_s`` without progress, not
  one that runs longer than ``timeout_s``: ranks that beat (as the
  launcher's do once a step) outlive it; ranks that stop beating are
  ended in about ``timeout_s``.
* A 2×1 launcher incarnation runs past its short ``--rank-timeout``
  because its ranks keep stepping. SIGTERM sent then to the launcher's
  whole process group is the reclaim notice: the ranks ignore it, rank 0
  reads it after its step, every rank sends its shards to the publish,
  and the next incarnation resumes from that CMI and finishes the job.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from repro_torch.core import JobStore
from repro_torch.core.cmi import restore_cmi
from repro_torch.distributed.group import beat, run_ranks
from repro_torch.launch.train import state_digest

SRC = str(Path(__file__).resolve().parent.parent / "src")
TIMEOUT_S = 8.0  # the progress timeout of the run_ranks test
RANK_TIMEOUT_S = 10.0  # the launcher's; a rank process takes ~3 s to join its group
STEPS = 300  # ~0.07 s a step on the CPU: the reclaim comes about halfway


def _paced(rank: int, rounds: int, pause: float) -> int:
    import torch.distributed as dist

    for _ in range(rounds):
        time.sleep(pause)
        dist.all_reduce(torch.ones(1))
        beat()
    return rank


def _stalls(rank: int, pause: float) -> int:
    time.sleep(pause)
    return rank


def test_ranks_that_make_progress_outlive_the_timeout():
    """Two ranks that beat every 3 s for 12 s finish past an 8 s timeout;
    two that stop beating are ended after about 8 s."""
    t0 = time.monotonic()
    assert run_ranks(_paced, 2, args=(4, 3.0), timeout_s=TIMEOUT_S, threads=1) == [0, 1]
    assert time.monotonic() - t0 > 12.0 > TIMEOUT_S
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="no progress in 8.0 s"):
        run_ranks(_stalls, 2, args=(120.0,), timeout_s=TIMEOUT_S, threads=1)
    assert time.monotonic() - t0 < 60.0


def _records(path: Path) -> list[dict]:
    text = path.read_text() if path.exists() else ""
    return [json.loads(ln) for ln in text.splitlines() if ln.endswith("}")]


def _took(rec: list[dict], incarnation: int) -> float:
    """Seconds an incarnation spent starting, stepping and publishing."""
    return sum(r["s"] for r in rec if r.get("incarnation") == incarnation and "s" in r)


def test_sigterm_to_the_process_group_reclaims_a_2x1_incarnation(tmp_path):
    """The launcher on a 2×1 mesh with ``--rank-timeout 10``: once its
    first incarnation has spent more than 10 s stepping, SIGTERM goes to
    every process of its group. Rank 0 publishes after its step k (every
    rank's shards) and the incarnation ends as preempted; the second
    starts from that CMI (its restored state is bitwise the published
    one), steps k+1..300 and finishes the job."""
    store, metrics = tmp_path / "jobs", tmp_path / "m.jsonl"
    env = {**os.environ, "PYTHONPATH": SRC}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-1.7b", "--smoke",
         "--device", "cpu", "--steps", str(STEPS), "--publish-every", str(10 * STEPS),
         "--seq-len", "16", "--batch", "4", "--log-every", "0", "--mesh", "2x1",
         "--rank-timeout", str(RANK_TIMEOUT_S), "--store", str(store), "--metrics", str(metrics)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, start_new_session=True)
    try:
        deadline = time.monotonic() + 120
        while _took(_records(metrics), 0) <= RANK_TIMEOUT_S:
            assert proc.poll() is None and time.monotonic() < deadline, proc.stdout.read()
            time.sleep(0.05)
        os.killpg(proc.pid, signal.SIGTERM)
        out, _ = proc.communicate(timeout=180)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, out.decode()[-4000:]
    assert b"reclaim notice (SIGTERM)" in out
    rec = _records(metrics)
    starts = [r for r in rec if r["event"] == "start"]
    assert [(s["mesh"], s["resumed"]) for s in starts] == [("2x1", False), ("2x1", True)]
    k = starts[1]["step"]
    assert 1 <= k < STEPS and _took(rec, 0) > RANK_TIMEOUT_S
    steps = [(r["incarnation"], r["step"]) for r in rec if r["event"] == "step"]
    assert steps == [(0, s) for s in range(1, k + 1)] + [(1, s) for s in range(k + 1, STEPS + 1)]
    publishes = [(r["incarnation"], r["step"]) for r in rec if r["event"] == "publish"]
    assert publishes == [(0, k), (1, STEPS)]
    js = JobStore(store)
    (job_id, _), = js.svc_list_jobs()
    assert js.read_job(job_id).status == "finished" and rec[-1]["incarnations"] == 2
    published = next(r["cmi"] for r in rec if r["event"] == "publish" and r["step"] == k)
    state, _ = restore_cmi(js.cmi_root(job_id), published, device="cpu")
    assert starts[1]["restored_digest"] == state_digest(state)
