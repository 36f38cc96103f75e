"""navlint: migration-safety static analysis for NavP programs.

The paper's programming model asks application code to carry live state
across ``hop()``/``publish()`` boundaries; this package closes the
laptop-to-Cloud gap by telling the programmer *before* a run that the
carried state is un-migratable (NAV1xx–NAV4xx) and that the fabric's
chaos surface is fully covered (NAV5xx):

* :mod:`repro_torch.analysis.walker` — one AST pass per module into a rule-
  facing model;
* :mod:`repro_torch.analysis.rules` — the NAV rule registry and engine;
* :mod:`repro_torch.analysis.stageref` — static twin of the runtime stage-ref
  resolver (shares ``itinerary.ref_obstacle``);
* :mod:`repro_torch.analysis.coverage` — faults.fire ↔ SITES ↔ matrix ↔ docs
  cross-check;
* :mod:`repro_torch.analysis.cli` — ``python -m repro_torch.analysis``.
"""

from repro_torch.analysis.cli import lint_paths, main  # noqa: F401
from repro_torch.analysis.coverage import check_coverage, extract_fire_sites  # noqa: F401
from repro_torch.analysis.rules import CATALOG, Finding, lint_module  # noqa: F401
from repro_torch.analysis.walker import parse_module  # noqa: F401
