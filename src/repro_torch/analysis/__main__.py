"""CLI: ``python -m repro_torch.analysis [--strict] [paths...]``.

Default mode lints the given paths (default: the ``repro_torch`` package
sources, its CUDA kernels included) with the four static passes and prints
a per-rule summary including counted, justified suppressions.
``--strict`` exits non-zero when any UNSUPPRESSED finding remains.

``--footprint-report OUT.json`` writes the closed-form device/host
resident-bytes model of the port's allocations (per engine x quantized
mode, at the declared dim bounds) in the reference's BENCH-style schema.
``--footprint-dims`` overrides the default 180M x 2048d bounds with the
same ``name<=value`` grammar as the ``dims[...]`` directive (``n_part``,
the largest partition, is one more name).

``--race-stress`` runs the seeded multi-submitter lifecycle churn with
``InstrumentedLock`` lock-order recording instead, on the card unless
``--device cpu``: exits non-zero on any lock-order cycle or
guarded-attribute violation.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter

from repro_torch.analysis import analyze_paths
from repro_torch.analysis.rules import RULES
from repro_torch.analysis.scalecheck import footprint_report
from repro_torch.analysis.symdims import fmt_bytes, parse_dims


def _default_paths() -> list[str]:
    import repro_torch

    return [os.path.dirname(os.path.abspath(repro_torch.__file__))]


def _lint(args: argparse.Namespace) -> int:
    paths = args.paths or _default_paths()
    findings = analyze_paths(paths)
    active = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]
    for f in findings:
        print(f.render())
    print()
    print(f"repro_torch.analysis: {len(active)} finding(s), "
          f"{len(suppressed)} suppressed, over {len(paths)} path(s)")
    for code, n in sorted(Counter(f.code for f in active).items()):
        print(f"  {code} ({RULES[code].name}): {n}")
    if suppressed:
        print("suppressions (justification required and counted):")
        for f in suppressed:
            print(f"  {f.path}:{f.line}: {f.code} -- {f.justification}")
    return 1 if active and args.strict else 0


def _footprint(args: argparse.Namespace) -> int:
    dims = parse_dims(args.footprint_dims, where="--footprint-dims") \
        if args.footprint_dims else None
    report = footprint_report(dims)
    payload = {
        "schema_version": 1,
        "bench": "footprint",
        "smoke": False,
        "created_unix": time.time(),
        "config": {"dims": report["dims"], "pad_model": report["pad_model"]},
        "metrics": report["metrics"],
        "rows": report["rows"],
    }
    with open(args.footprint_report, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    d = report["dims"]
    print(f"footprint report ({', '.join(f'{k}={v:_}' for k, v in d.items())})"
          f" -> {args.footprint_report}")
    for key, val in sorted(report["metrics"].items()):
        print(f"  {key}: {fmt_bytes(val)}")
    return 0


def _race_stress(args: argparse.Namespace) -> int:
    from repro_torch.analysis.runtime import race_stress

    def progress(report):
        print(f"  cycle {report.cycles_run}: {report.submitted} submitted, "
              f"{report.completed} completed", flush=True)

    print(f"race-stress: threads={args.threads} duration={args.duration}s "
          f"seed={args.seed} device={args.device or 'cuda'}", flush=True)
    report = race_stress(threads=args.threads, duration_s=args.duration,
                         seed=args.seed, progress=progress,
                         device=args.device)
    print(report.render())
    return 0 if report.ok else 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Host-sync, lock-discipline, CUDA-kernel and scale "
                    "invariant checks.",
    )
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the "
                         "repro_torch package)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 if any unsuppressed finding remains")
    ap.add_argument("--footprint-report", metavar="OUT.json",
                    help="write the closed-form resident-bytes report "
                         "instead of linting")
    ap.add_argument("--footprint-dims", metavar="DIMS",
                    help="override footprint bounds, e.g. "
                         "'n<=10_000_000, d<=512, P<=64, M<=16'")
    ap.add_argument("--race-stress", action="store_true",
                    help="run the seeded multi-submitter lock-order stress "
                         "instead of linting")
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--duration", type=float, default=30.0,
                    help="race-stress wall-clock budget in seconds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="race-stress index device (default: the card)")
    args = ap.parse_args(argv)
    if args.race_stress:
        return _race_stress(args)
    if args.footprint_report:
        return _footprint(args)
    return _lint(args)


if __name__ == "__main__":
    sys.exit(main())
