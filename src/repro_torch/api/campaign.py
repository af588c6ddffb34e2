"""Campaign — a declarative scenario grid run through the Session facade
(the port of ``repro.api.campaign``: the same schema, so either package
reads the other's artifact).

The paper's configuration guidelines answer one question at a time: given
an architecture, a batch size, a sync schedule, a topology — how fast, how
efficient?  ``Session.sweep`` asks them all at once: a grid over JobSpec
fields fans out into one :class:`repro_torch.api.Report` per cell, and the
:class:`Campaign` collects them with a Pareto summary of throughput vs
efficiency.

    from repro_torch.api import JobSpec, Session

    camp = Session.sweep(
        JobSpec(arch="granite-3-2b", steps=2, batch=4, seq=32),
        {"arch": ["granite-3-2b", "mamba2-780m"],
         "topology": ["h100-8", "h100-2x8"]},
        kind="plan")
    camp.summary()["pareto"]         # the non-dominated cells
    camp.save("results/campaign.json")

Cells whose combination is invalid (e.g. ``batch`` not divisible by
``dp``), or that do not fit the card, are recorded under ``skipped``
instead of aborting the campaign.  Predictive (plan/dryrun) campaigns only
differentiate plan-affecting fields (arch/shape/mesh/topology); sweep
execution knobs (batch/compress/dp/sync) with ``kind="train"``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Sequence, Union

from repro_torch.api.report import Report, validate_report
from repro_torch.configs.base import get_shape

CAMPAIGN_SCHEMA_ID = "repro.api/campaign/v1"


def _cell_metrics(rep: Report) -> Dict[str, Any]:
    """Throughput (tokens/s) and Lemma-3.1 efficiency for one cell —
    measured when the cell ran, planner-predicted for plan/dryrun cells."""
    measured_tps = rep.measured.get("tokens_per_s")
    if measured_tps is not None:
        tps = float(measured_tps)
        source = "measured"
    else:
        est = float(rep.plan.get("est_step_time") or 0.0)
        shape = get_shape(rep.plan["shape"])
        tokens = shape.global_batch * shape.seq_len
        tps = tokens / est if 0.0 < est < float("inf") else 0.0
        source = "predicted"
    return {
        "tokens_per_s": tps,
        "efficiency": float(rep.plan.get("efficiency") or 0.0),
        "source": source,
        "schedule": rep.plan.get("sync_schedule", ""),
        "bottleneck_tier": rep.plan.get("bottleneck_tier", ""),
        "fits": bool(rep.plan.get("fits", True)),
    }


def pareto_front(points: Sequence[Dict[str, float]]) -> List[int]:
    """Indices of the cells not dominated on (tokens_per_s, efficiency):
    no other cell is >= on both axes and > on at least one."""
    idx = []
    for i, p in enumerate(points):
        dominated = any(
            q["tokens_per_s"] >= p["tokens_per_s"]
            and q["efficiency"] >= p["efficiency"]
            and (q["tokens_per_s"] > p["tokens_per_s"]
                 or q["efficiency"] > p["efficiency"])
            for j, q in enumerate(points) if j != i)
        if not dominated:
            idx.append(i)
    return idx


@dataclass
class Campaign:
    """All reports of one sweep plus the grid that produced them."""

    kind: str                      # Session method run per cell
    grid: Dict[str, List[Any]]     # field -> values swept
    cells: List[Dict[str, Any]]    # per-report {overrides} in report order
    reports: List[Report] = field(default_factory=list)
    skipped: List[Dict[str, Any]] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.reports)

    # ------------------------------------------------------------------
    def metrics(self) -> List[Dict[str, Any]]:
        return [dict(cell, **_cell_metrics(rep))
                for cell, rep in zip(self.cells, self.reports)]

    def pareto(self) -> List[int]:
        return pareto_front(self.metrics())

    def summary(self) -> Dict[str, Any]:
        m = self.metrics()
        front = pareto_front(m)
        best_tps = max(range(len(m)), key=lambda i: m[i]["tokens_per_s"],
                       default=None) if m else None
        best_eff = max(range(len(m)), key=lambda i: m[i]["efficiency"],
                       default=None) if m else None
        return {
            "kind": self.kind,
            "n_cells": len(self.reports) + len(self.skipped),
            "n_ok": len(self.reports),
            "n_skipped": len(self.skipped),
            "cells": m,
            "pareto": [m[i] for i in front],
            "pareto_indices": front,
            "best_throughput": m[best_tps] if best_tps is not None else None,
            "best_efficiency": m[best_eff] if best_eff is not None else None,
        }

    # ------------------------------------------------------------------
    def validate(self) -> "Campaign":
        for rep in self.reports:
            validate_report(rep.to_dict())
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": CAMPAIGN_SCHEMA_ID,
            "kind": self.kind,
            "grid": self.grid,
            "summary": self.summary(),
            "reports": [r.to_dict() for r in self.reports],
            "skipped": self.skipped,
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, default=str)

    def save(self, path: Union[str, Path]) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.to_json())
        return p

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Campaign":
        if d.get("schema") != CAMPAIGN_SCHEMA_ID:
            raise ValueError(f"campaign schema {d.get('schema')!r} != "
                             f"{CAMPAIGN_SCHEMA_ID!r}")
        reports = [Report.from_dict(r) for r in d["reports"]]
        grid_keys = set(d.get("grid", {}))
        cells = [{k: v for k, v in c.items() if k in grid_keys}
                 for c in d.get("summary", {}).get("cells", [])]
        return cls(kind=d["kind"], grid=dict(d.get("grid", {})), cells=cells,
                   reports=reports, skipped=list(d.get("skipped", [])))

    @classmethod
    def from_json(cls, s: str) -> "Campaign":
        return cls.from_dict(json.loads(s))
