"""The paper's proof-of-concept on PyTorch, end to end: VIIRS→CrIS
co-location as a NavP itinerary (Figures 7 & 8).

Two nodes model the paper's second experiment: a *data host* (where granules
live) and a *compute host*. The program is written as a sequential itinerary
that hops to the data, hops back to compute, and hops again to publish — the
Lagrangian view — with `publish("ckpt")` after each stage so a reclaim
resumes mid-pipeline. On the CUDA card the match runs the colocate kernel
(K2); with ``--device cpu`` its plain version.

    PYTHONPATH=src python examples/torch_navp_colocation.py [--device cpu]

The same itinerary runs unchanged across *process-backed* nodes
(``repro_torch.fabric``); these stages are defined in a script's
``__main__``, so a remote runner would fetch the state and run them
driver-side (see ``examples/navp_colocation.py``).
"""

import argparse
import sys
import tempfile

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.core import DHP, NBS, JobStore  # noqa: E402
from repro_torch.core import colocation as co  # noqa: E402
from repro_torch.core.itinerary import Itinerary, Stage  # noqa: E402
from repro_torch.core.jobstore import STATUS_FINISHED  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = ap.parse_args()

root = tempfile.mkdtemp(prefix="navp-coloc-")
nbs = NBS(root + "/s3")
nbs.add_node("data-host", device=args.device)     # granule storage server
nbs.add_node("compute-host", device=args.device)  # number-cruncher
store = JobStore(root + "/jobs")
job = store.create_job({"app": "viirs-cris-colocation"})
dhp = DHP(nbs, "compute-host", store)


# --- the science code, written as plain sequential stages ------------------
def read_granules(s):
    s = co.stage_read(s, device=args.device, seed=0, n_scans=6, viirs_pixels_per_scan=1600,
                      viirs_lines_per_scan=8)
    print(f"  read {s['viirs_lat'].numel()} VIIRS pixels, {s['cris_lat'].numel()} CrIS FOVs")
    return s


def compute_vectors(s):
    los = co.cris_los_ecef(s["cris_lat"], s["cris_lon"], s["sat_pos"])   # Fig 7 line 10
    pos = co.viirs_pos_ecef(s["viirs_lat"], s["viirs_lon"])              # Fig 7 line 11
    return {**s, "los": los, "pos": pos}


def match(s):
    idx, cos, within = co.match_viirs_to_cris(s["pos"], s["los"], s["sat_pos"])  # line 13
    print(f"  matched {float(within.to(torch.float32).mean()) * 100:.1f}% of pixels")
    return {**s, "idx": idx, "within": within}


def write_back(s):
    return s  # the publish after this stage is the "write" (Fig. 8)


# --- Figure 8: three hops between data and compute hosts -------------------
# NAV104 suppressed by intent: these stages live in a script, so remote
# runners localize the state and run them driver-side — the degradation
# the module docstring documents.
itinerary = Itinerary(dhp, job.job_id)
stages = [  # to the data, to compute, and back to the data to publish
    Stage("data-host", read_granules, "read", publish=True),  # navlint: disable=NAV104
    Stage("compute-host", compute_vectors, "geometry", publish=True),  # navlint: disable=NAV104
    Stage("compute-host", match, "match", publish=True),  # navlint: disable=NAV104
    Stage("data-host", write_back, "write"),  # navlint: disable=NAV104
]
print("running itinerary:")
state = itinerary.run({}, stages)
print("  execution trace:", itinerary.trace)

prod = co.build_product(
    {"cris_lat": state["cris_lat"], "viirs_rad": state["viirs_rad"]}, state["idx"], state["within"],
)
dhp.publish(job.job_id, STATUS_FINISHED, product={
    "matched_frac": prod["matched_frac"],
    "cris_mean_rad": prod["cris_mean_rad"],
    "cris_match_count": prod["cris_match_count"],
})
jobs = store.svc_list_jobs()
print("job status:", jobs)
assert [status for _, status in jobs] == [STATUS_FINISHED], jobs
print(f"product: matched_frac={prod['matched_frac']:.3f}, "
      f"mean matches/FOV={prod['cris_match_count'].mean():.1f}")
