"""The port's facade: ``JobSpec`` -> ``Session.plan()`` / ``.dryrun()`` /
``.tune()`` / ``.train()`` / ``.bench()`` / ``.serve()`` -> ``Report``,
every report checked by ``validate_report``; ``Session.sweep`` runs one
of them per cell of a grid into a ``Campaign`` (one Report per cell plus
a throughput-vs-efficiency Pareto summary)."""
from repro_torch.api.campaign import CAMPAIGN_SCHEMA_ID, Campaign, pareto_front
from repro_torch.api.report import (KINDS, SCHEMA_ID, TUNING_SCHEMA_ID,
                                    Report, validate_report)
from repro_torch.api.session import Session
from repro_torch.api.spec import COMPRESSIONS, JobSpec, MESHES, SYNCS, TOPOLOGIES

__all__ = [
    "JobSpec", "Session", "Report", "Campaign", "validate_report",
    "pareto_front", "SCHEMA_ID", "CAMPAIGN_SCHEMA_ID", "TUNING_SCHEMA_ID",
    "KINDS", "MESHES", "SYNCS", "COMPRESSIONS", "TOPOLOGIES",
]
