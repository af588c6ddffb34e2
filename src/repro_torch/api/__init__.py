"""The port's facade: ``JobSpec`` -> ``Session.plan()`` / ``.dryrun()`` /
``.tune()`` / ``.train()`` / ``.bench()`` / ``.serve()`` -> ``Report``,
every report checked by ``validate_report``."""
from repro_torch.api.report import (KINDS, SCHEMA_ID, TUNING_SCHEMA_ID,
                                    Report, validate_report)
from repro_torch.api.session import Session
from repro_torch.api.spec import JobSpec

__all__ = ["JobSpec", "Report", "Session", "validate_report", "SCHEMA_ID",
           "TUNING_SCHEMA_ID", "KINDS"]
