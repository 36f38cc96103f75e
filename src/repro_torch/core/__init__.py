"""NavP core — the paper's primary contribution, on torch devices.

Modules:
  cmi         Checkpoint Memory Image: tensor-tree snapshot/save/restore onto
              a device.
  jobstore    Job database with the paper's status machine (new/ckpt/finished)
              and the three services: svc/list_jobs, svc/get_job,
              svc/publish_job.
  nbs         NavP Bridging Services: per-node service registry + svc/hop.
  dhp         The DHP tool (DMTCP Hop & Publish analogue): hop(dest) and
              publish(dest, status), Figures 3/4/6 of the paper.
  delta       Incremental (delta) CMIs with on-device change detection (§Q3).
  preemption  Spot-instance preemption notices + market simulator (§2.2, Q1).
  itinerary   DSC itineraries: sequential programs hopping across nodes.
  plugins     DMTCP-plugin-style event hooks (on_checkpoint/on_restart/on_hop).
  colocation  The paper's VIIRS/CrIS co-location application.
"""

from repro_torch.core.cmi import (  # noqa: F401
    device_resolver,
    restore_cmi,
    save_cmi,
    snapshot_to_host,
)
from repro_torch.core.jobstore import Job, JobStore  # noqa: F401
from repro_torch.core.nbs import NBS, Node  # noqa: F401
from repro_torch.core.dhp import DHP, Preempted  # noqa: F401
