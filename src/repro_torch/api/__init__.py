"""The port's facade: ``JobSpec`` -> ``Session.serve()`` -> ``ServeReport``."""
from repro_torch.api.session import ServeReport, Session
from repro_torch.api.spec import JobSpec

__all__ = ["JobSpec", "ServeReport", "Session"]
