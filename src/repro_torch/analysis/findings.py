"""Finding records and baseline (suppression) plumbing for
``repro_torch.analysis``: a copy of ``repro.analysis.findings``, with the
same schema ids, so a payload or a baseline made by either package
validates in the other.

Every analyzer emits :class:`Finding` rows.  A finding's *fingerprint* is
``code:path:context``, free of line numbers, so a justified suppression
in ``tools/torch_lint_baseline.json`` survives unrelated edits that shift
lines.  ``context`` is the dotted qualname of the enclosing def/class for
AST findings (``"<module>"`` at file scope) or an ``op:arch:shape:...``
string for kernel-contract findings.

Two schema ids, registered with the schema-drift analyzer like every
other ``repro.*`` payload:

- ``repro.analysis/findings/v1``: the ``--json`` artifact of
  ``tools/torch_lint.py`` (findings, suppression accounting, wall clock).
- ``repro.analysis/baseline/v1``: the committed suppression file; each
  entry carries a mandatory human ``reason``.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Iterable, List, Tuple

FINDINGS_SCHEMA_ID = "repro.analysis/findings/v1"
BASELINE_SCHEMA_ID = "repro.analysis/baseline/v1"


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    path: str  # repo-relative, forward slashes
    line: int  # 1-based; 0 when the finding has no single line
    code: str  # e.g. "DT102"
    message: str
    context: str = "<module>"

    @property
    def fingerprint(self) -> str:
        return f"{self.code}:{self.path}:{self.context}"

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint
        return d

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}: {self.code} {self.message} "
                f"[{self.context}]")


# ---------------------------------------------------------------------------
# Baseline file
# ---------------------------------------------------------------------------


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"{BASELINE_SCHEMA_ID}: {msg}")


def validate_baseline(d: Any) -> Dict[str, Any]:
    _require(isinstance(d, dict), f"expected object, got {type(d).__name__}")
    _require(d.get("schema") == BASELINE_SCHEMA_ID,
             f"schema {d.get('schema')!r} != {BASELINE_SCHEMA_ID!r}")
    sup = d.get("suppressions")
    _require(isinstance(sup, list), "suppressions must be a list")
    for i, s in enumerate(sup):
        _require(isinstance(s, dict), f"suppressions[{i}] must be an object")
        fp, reason = s.get("fingerprint"), s.get("reason")
        _require(isinstance(fp, str) and fp.count(":") >= 2,
                 f"suppressions[{i}].fingerprint must be code:path:context")
        _require(isinstance(reason, str) and reason.strip() != "",
                 f"suppressions[{i}].reason must be a non-empty string")
    return d


def load_baseline(path: Path) -> Dict[str, str]:
    """fingerprint -> reason; missing file means an empty baseline."""
    if not Path(path).exists():
        return {}
    d = validate_baseline(json.loads(Path(path).read_text()))
    return {s["fingerprint"]: s["reason"] for s in d["suppressions"]}


def apply_baseline(
    findings: Iterable[Finding], suppressions: Dict[str, str]
) -> Tuple[List[Finding], List[Finding], List[str]]:
    """Split findings into (unbaselined, suppressed) and report stale
    suppression fingerprints that matched nothing (a fixed finding whose
    baseline entry should be deleted)."""
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    hit = set()
    for f in findings:
        if f.fingerprint in suppressions:
            suppressed.append(f)
            hit.add(f.fingerprint)
        else:
            kept.append(f)
    stale = sorted(set(suppressions) - hit)
    return kept, suppressed, stale


def make_baseline(findings: Iterable[Finding],
                  reasons: Dict[str, str]) -> Dict[str, Any]:
    """Build a baseline document suppressing ``findings`` (deduped by
    fingerprint); ``reasons`` may pre-seed justifications."""
    sup: Dict[str, str] = {}
    for f in findings:
        sup.setdefault(f.fingerprint,
                       reasons.get(f.fingerprint, "TODO: justify"))
    return {
        "schema": BASELINE_SCHEMA_ID,
        "suppressions": [{"fingerprint": fp, "reason": r}
                         for fp, r in sorted(sup.items())],
    }


# ---------------------------------------------------------------------------
# Findings artifact (the --json payload)
# ---------------------------------------------------------------------------


def make_findings_payload(unbaselined: List[Finding],
                          suppressed: List[Finding],
                          stale: List[str],
                          wall_s: float) -> Dict[str, Any]:
    return {
        "schema": FINDINGS_SCHEMA_ID,
        "findings": [f.to_dict() for f in sorted(unbaselined)],
        "suppressed": [f.to_dict() for f in sorted(suppressed)],
        "stale_suppressions": list(stale),
        "wall_s": float(wall_s),
        "clean": not unbaselined,
    }


def validate_findings(d: Any) -> Dict[str, Any]:
    if not isinstance(d, dict):
        raise ValueError(f"{FINDINGS_SCHEMA_ID}: expected object")
    if d.get("schema") != FINDINGS_SCHEMA_ID:
        raise ValueError(f"{FINDINGS_SCHEMA_ID}: schema "
                         f"{d.get('schema')!r} != {FINDINGS_SCHEMA_ID!r}")
    for key in ("findings", "suppressed", "stale_suppressions"):
        if not isinstance(d.get(key), list):
            raise ValueError(f"{FINDINGS_SCHEMA_ID}: {key} must be a list")
    for row in d["findings"] + d["suppressed"]:
        for k in ("path", "line", "code", "message", "context",
                  "fingerprint"):
            if k not in row:
                raise ValueError(f"{FINDINGS_SCHEMA_ID}: finding missing {k}")
    if not isinstance(d.get("wall_s"), (int, float)):
        raise ValueError(f"{FINDINGS_SCHEMA_ID}: wall_s must be a number")
    if d.get("clean") != (not d["findings"]):
        raise ValueError(f"{FINDINGS_SCHEMA_ID}: clean flag inconsistent "
                         "with findings list")
    return d
