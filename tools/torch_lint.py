"""torch-lint — the PyTorch/CUDA port's static-analysis gate.

Runs the four ``repro_torch.analysis`` analyzers (Hopper kernel
contracts, determinism, mesh axes, schema drift) over the port, subtracts the
committed baseline (``tools/torch_lint_baseline.json``: justified
suppressions keyed by line-stable fingerprints), and exits non-zero on
any *unbaselined* finding.  ``tools/repro_lint.py``'s flags, output and
exit codes; it runs on the host, needs no card and starts no process.

    PYTHONPATH=src python tools/torch_lint.py              # human output
    PYTHONPATH=src python tools/torch_lint.py --json \\
        --out results/torch_lint_findings.json             # the artifact
    PYTHONPATH=src python tools/torch_lint.py --analyzer determinism
    PYTHONPATH=src python tools/torch_lint.py --analyzer mesh
    PYTHONPATH=src python tools/torch_lint.py --write-baseline  # accept all

Baseline workflow: fix findings where possible; for a justified
exception, add ``{"fingerprint": "CODE:path:context", "reason": "..."}``
to the baseline by hand (or ``--write-baseline``, then edit every
``TODO: justify``), the reason naming the JAX package's counterpart.
Stale suppressions (matching nothing) are reported so fixed findings do
not leave dead entries behind.  The card's side of the kernel contracts
is ``repro_torch.analysis.kernel_contracts.card_check`` (``chip_smoke.py``
phase 19).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
DEFAULT_BASELINE = REPO / "tools" / "torch_lint_baseline.json"
# each analyzer's finding-code prefix
CODES = {"kernel": "KC", "determinism": "DT", "mesh": "MX", "schema": "SD"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true",
                    help="emit the findings payload (JSON)")
    ap.add_argument("--out", default="",
                    help="also write the JSON payload to this file")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="suppression file (the baseline schema)")
    ap.add_argument("--analyzer", action="append", default=None,
                    choices=["kernel", "determinism", "mesh", "schema"],
                    help="run only these analyzers (repeatable)")
    ap.add_argument("--root", default=str(REPO),
                    help="tree to analyze (default: this repo; the kernel "
                         "analyzer always audits the imported registry)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write a baseline suppressing every current "
                         "finding (reasons start as 'TODO: justify')")
    args = ap.parse_args(argv)

    if str(REPO / "src") not in sys.path:
        sys.path.insert(0, str(REPO / "src"))
    from repro_torch.analysis import (apply_baseline, load_baseline,
                                      make_baseline, make_findings_payload,
                                      run_analyzers)
    from repro_torch.obs.trace import monotonic

    t0 = monotonic()
    findings = run_analyzers(Path(args.root), args.analyzer)

    if args.write_baseline:
        reasons = load_baseline(Path(args.baseline))
        doc = make_baseline(findings, reasons)
        Path(args.baseline).write_text(json.dumps(doc, indent=2) + "\n")
        print(f"wrote {args.baseline}: {len(doc['suppressions'])} "
              "suppression(s)")
        return 0

    suppressions = load_baseline(Path(args.baseline))
    if args.analyzer:  # a suppression of an analyzer not run is not stale
        codes = tuple(CODES[a] for a in args.analyzer)
        suppressions = {fp: r for fp, r in suppressions.items()
                        if fp.startswith(codes)}
    unbaselined, suppressed, stale = apply_baseline(findings, suppressions)
    payload = make_findings_payload(unbaselined, suppressed, stale,
                                    monotonic() - t0)

    if args.out:
        out_path = Path(args.out)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(payload, indent=2) + "\n")
    if args.json:
        print(json.dumps(payload, indent=2))
    else:
        for f in unbaselined:
            print(f)
        for fp in stale:
            print(f"stale suppression (fix landed? delete it): {fp}",
                  file=sys.stderr)
        print(f"torch-lint: {len(unbaselined)} finding(s), "
              f"{len(suppressed)} suppressed, {len(stale)} stale, "
              f"{payload['wall_s']:.1f}s")
    return 1 if unbaselined else 0


if __name__ == "__main__":
    sys.exit(main())
