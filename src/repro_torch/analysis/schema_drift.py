"""Schema-drift analyzer (SD1xx) over ``src/repro_torch`` and
``tools/torch_*.py``, the port's twin of ``repro.analysis.schema_drift``.

The port writes JAX's payloads (the checkpoint manifest, the Report
family, campaigns, metrics, the tuning cache, the bench trajectory and
the lint findings/baseline pair) with its own hand-rolled validators.
These rules tie each schema-id literal to a validator of the port's:

- **SD101**: a schema-id-shaped string literal (``repro.<pkg>/<name>/vN``)
  in the scanned files that no known validator claims.
- **SD102**: a registered schema id that appears nowhere in the scanned
  files (a validator for a payload nothing emits).
- **SD103**: the port's ``HISTOGRAM_KEYS`` drifted from what its
  ``Histogram.summary()`` emits, or a smoke ``MetricsRegistry.section()``
  fails its own ``validate_metrics``.
- **SD104**: a golden in ``tests/goldens/`` fails the port's validator.
  The goldens are JAX's, of the same schemas, so this holds the port's
  validators to them.
- **SD105**: a golden JSON with no validator mapping.
"""
from __future__ import annotations

import ast
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Tuple

from repro_torch.analysis.findings import Finding

# matches exactly a schema-id literal: repro.<pkg>/<slug>/v<N>
SCHEMA_ID_RE = re.compile(r"\Arepro\.[a-z_]+/[A-Za-z0-9._-]+/v\d+\Z")

# (directory, glob): the port's package and its tools
SCAN = (("src/repro_torch", "**/*.py"), ("tools", "torch_*.py"))
TRAJECTORY_TOOL = "tools/torch_bench_trajectory.py"


def known_schema_ids() -> Dict[str, str]:
    """schema id -> 'module:validator' for every payload the port
    registers."""
    from repro_torch.analysis import findings as an_findings
    from repro_torch.api import campaign as api_campaign
    from repro_torch.api import report as api_report
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import autotune as core_autotune
    from repro_torch.obs import metrics as obs_metrics

    ids = {
        ckpt_io.MANIFEST_SCHEMA_ID:
            "repro_torch.checkpoint.io:validate_manifest",
        api_report.SCHEMA_ID: "repro_torch.api.report:validate_report",
        api_report.TUNING_SCHEMA_ID:
            "repro_torch.api.report:_validate_tuning",
        api_report.SERVING_SCHEMA_ID:
            "repro_torch.api.report:_validate_serving",
        api_campaign.CAMPAIGN_SCHEMA_ID:
            "repro_torch.api.campaign:Campaign.from_dict",
        obs_metrics.METRICS_SCHEMA_ID:
            "repro_torch.obs.metrics:validate_metrics",
        core_autotune.CACHE_SCHEMA_ID:
            "repro_torch.core.autotune:load_cache",
        an_findings.FINDINGS_SCHEMA_ID:
            "repro_torch.analysis.findings:validate_findings",
        an_findings.BASELINE_SCHEMA_ID:
            "repro_torch.analysis.findings:validate_baseline",
    }
    ids[_trajectory_schema_id()] = f"{TRAJECTORY_TOOL}:load_trajectory"
    return ids


def _trajectory_schema_id() -> str:
    """The port's trajectory tool's id, loaded by path (``tools/`` is not
    a package); the committed literal if the tool moved (SD102 then flags
    the drift)."""
    path = Path(__file__).resolve().parents[3] / TRAJECTORY_TOOL
    try:
        spec = importlib.util.spec_from_file_location("_torch_bench_traj",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.TRAJECTORY_SCHEMA_ID
    except Exception:
        return "repro.obs/bench-trajectory/v1"


# ---------------------------------------------------------------------------
# SD101/SD102: literal <-> registry cross-check
# ---------------------------------------------------------------------------


def schema_literals(src: str, path: str) -> List[Tuple[str, int]]:
    """(schema id, line) for every schema-id-shaped string constant."""
    return [(node.value, node.lineno)
            for node in ast.walk(ast.parse(src, filename=path))
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and SCHEMA_ID_RE.match(node.value)]


def analyze_literals(pairs, known: Dict[str, str]) -> List[Finding]:
    findings: List[Finding] = []
    seen: Dict[str, int] = {}
    for path, src in pairs:
        for sid, line in schema_literals(src, path):
            seen[sid] = seen.get(sid, 0) + 1
            if sid not in known:
                findings.append(Finding(
                    path=path, line=line, code="SD101",
                    message=f"schema id {sid!r} has no registered "
                            "validator", context=sid))
    for sid, where in sorted(known.items()):
        if sid not in seen:
            mod = where.split(":")[0]
            home = mod if mod.startswith("tools/") else (
                "src/" + mod.replace(".", "/") + ".py")
            findings.append(Finding(
                path=home, line=0, code="SD102",
                message=f"registered schema id {sid!r} appears nowhere in "
                        f"{[d for d, _ in SCAN]} — dead registration",
                context=sid))
    return findings


# ---------------------------------------------------------------------------
# SD103: HISTOGRAM_KEYS vs emitted metrics
# ---------------------------------------------------------------------------


def check_histogram_keys() -> List[Finding]:
    from repro_torch.obs.metrics import (HISTOGRAM_KEYS, Histogram,
                                         MetricsRegistry, validate_metrics)
    path = "src/repro_torch/obs/metrics.py"
    out: List[Finding] = []
    h = Histogram()
    for i in range(32):
        h.observe(float(i))
    emitted = tuple(h.summary())
    if emitted != tuple(HISTOGRAM_KEYS):
        out.append(Finding(
            path=path, line=0, code="SD103",
            message=f"Histogram.summary() emits {emitted}, but "
                    f"HISTOGRAM_KEYS declares {tuple(HISTOGRAM_KEYS)}",
            context="HISTOGRAM_KEYS"))
    reg = MetricsRegistry()
    reg.inc("lint/smoke_total", 3)
    reg.set_gauge("lint/smoke_gauge", 1.5)
    for i in range(8):
        reg.observe("lint/smoke_s", 0.1 * i)
    try:
        validate_metrics(reg.section())
    except Exception as e:
        out.append(Finding(
            path=path, line=0, code="SD103",
            message=f"MetricsRegistry.section() fails validate_metrics: "
                    f"{e}", context="MetricsRegistry.section"))
    return out


# ---------------------------------------------------------------------------
# SD104/SD105: goldens validate under the port's validators
# ---------------------------------------------------------------------------


def golden_validators() -> Dict[str, Callable]:
    """golden filename prefix -> the port's validator of the parsed JSON."""
    from repro_torch.api import Campaign, validate_report
    from repro_torch.obs.metrics import validate_metrics
    return {
        "report_": validate_report,
        "tuning_": validate_report,
        "campaign_": Campaign.from_dict,
        "metrics_": validate_metrics,
    }


def check_goldens(root) -> List[Finding]:
    root = Path(root)
    vals = golden_validators()
    out: List[Finding] = []
    for p in sorted((root / "tests" / "goldens").glob("*.json")):
        rel = p.relative_to(root).as_posix()
        fn = next((v for pre, v in vals.items()
                   if p.name.startswith(pre)), None)
        if fn is None:
            out.append(Finding(
                path=rel, line=0, code="SD105",
                message="golden has no validator mapping; add one to "
                        "repro_torch.analysis.schema_drift."
                        "golden_validators", context=p.name))
            continue
        try:
            fn(json.loads(p.read_text()))
        except Exception as e:
            out.append(Finding(
                path=rel, line=0, code="SD104",
                message=f"golden fails the port's validator: {e}",
                context=p.name))
    return out


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def scanned_sources(root) -> List[Tuple[str, str]]:
    """(repo-relative path, source) of every scanned file under ``root``."""
    root = Path(root)
    pairs = []
    for d, pattern in SCAN:
        base = root / d
        if base.exists():
            pairs.extend((p.relative_to(root).as_posix(), p.read_text())
                         for p in sorted(base.glob(pattern)))
    return pairs


def analyze(root) -> List[Finding]:
    out = analyze_literals(scanned_sources(root), known_schema_ids())
    out.extend(check_histogram_keys())
    out.extend(check_goldens(root))
    return sorted(out)
