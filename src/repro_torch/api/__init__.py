"""The port's facade: ``JobSpec`` -> ``Session.train()`` / ``.bench()`` /
``.serve()`` -> ``Report``."""
from repro_torch.api.session import Report, Session
from repro_torch.api.spec import JobSpec

__all__ = ["JobSpec", "Report", "Session"]
