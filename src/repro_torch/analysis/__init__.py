"""repro_torch.analysis: static analysis that proves the port's invariants
before it runs, the twin of ``repro.analysis``.

Four domain analyzers, each emitting
:class:`~repro_torch.analysis.findings.Finding` rows with stable
fingerprints (``code:path:context``), so justified suppressions in
``tools/torch_lint_baseline.json`` survive line drift:

- :mod:`~repro_torch.analysis.kernel_contracts` (KC2xx): the launches of
  the four Hopper kernels (grid, threads, shared memory, register cap and
  the residency their design claims) mirrored in pure math and audited at
  the registry's full-width shapes as the port routes them, the mirror
  held to the ``.cu`` text, and on the card (``card_check``) to what the
  compiled kernels report.
- :mod:`~repro_torch.analysis.determinism` (DT1xx): unseeded RNGs (torch's
  global RNG included), wall-clock reads outside
  ``repro_torch.obs.trace``, host syncs inside collective-issuing
  functions, non-atomic checkpoint writes.
- :mod:`~repro_torch.analysis.schema_drift` (SD1xx): schema-id literals
  against the port's validators, ``HISTOGRAM_KEYS`` against emitted
  metrics, the goldens against the port's validators.

- :mod:`~repro_torch.analysis.mesh_axes` (MX1xx): axis names passed to a
  group lookup against the axes the port's meshes declare, and
  ``torch.distributed`` collectives issued with no ``group=``.

``tools/torch_lint.py`` is the gate; ``docs/torch_static_analysis.md`` is
the rule catalogue.
"""
from repro_torch.analysis.findings import (BASELINE_SCHEMA_ID,
                                           FINDINGS_SCHEMA_ID, Finding,
                                           apply_baseline, load_baseline,
                                           make_baseline,
                                           make_findings_payload,
                                           validate_baseline,
                                           validate_findings)

from repro_torch.analysis import determinism, kernel_contracts, \
    mesh_axes, schema_drift  # noqa: E402  (re-exported as namespaces)

ANALYZERS = {
    "kernel": kernel_contracts.analyze,
    "determinism": determinism.analyze,
    "mesh": mesh_axes.analyze,
    "schema": schema_drift.analyze,
}


def run_analyzers(root, names=None):
    """Run the named analyzers (all by default) over the repo at ``root``;
    returns the combined sorted finding list."""
    out = []
    for name in names or sorted(ANALYZERS):
        out.extend(ANALYZERS[name](root))
    return sorted(out)


__all__ = [
    "ANALYZERS", "BASELINE_SCHEMA_ID", "FINDINGS_SCHEMA_ID", "Finding",
    "apply_baseline", "determinism", "kernel_contracts", "load_baseline",
    "make_baseline", "make_findings_payload", "mesh_axes", "run_analyzers",
    "schema_drift", "validate_baseline", "validate_findings",
]
