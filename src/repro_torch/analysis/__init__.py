"""repro_torch.analysis — static + runtime invariant checks for the port.

The port of ``repro.analysis`` (see analysis/README.md for the rule
catalog).  Four coordinated static passes and their runtime twins:

* ``tracelint``  — host-sync lint over hot-path functions (LANNS001-004,
  LANNS006): ``.item()``, ``.cpu()``, ``.tolist()``, scalar casts of CUDA
  tensors and per-iteration launches;
* ``locks``      — lock-discipline proof over ``_GUARDED_BY`` registries
  (LANNS010-013), with a runtime twin in ``runtime``
  (InstrumentedLock / race_stress);
* ``kernelcheck``— CUDA-kernel constraint check over kernels/ and its
  csrc/ sources (LANNS020, LANNS021, LANNS024);
* ``scalecheck`` — symbolic shape/dtype abstract interpretation at
  declared ``dims[...]`` bounds (LANNS030-032, LANNS034) plus the
  closed-form device-footprint report of the port's allocations.

Plus ``sentinels.RetraceSentinel``, the port's retrace counter (kernel
library loads, allocator segments).

CLI: ``python -m repro_torch.analysis [--strict] [paths...]``,
``python -m repro_torch.analysis --footprint-report OUT.json``, and
``python -m repro_torch.analysis --race-stress --threads 8 --duration 30``.
"""

from __future__ import annotations

import os

from repro_torch.analysis import kernelcheck, locks, scalecheck, tracelint
from repro_torch.analysis.rules import CUDA_SUFFIXES, RULES, Finding, SourceFile
from repro_torch.analysis.scalecheck import DEFAULT_FOOTPRINT_DIMS, footprint_report
from repro_torch.analysis.sentinels import RetraceSentinel

__all__ = [
    "RULES", "Finding", "SourceFile", "RetraceSentinel",
    "analyze_file", "analyze_paths",
    "footprint_report", "DEFAULT_FOOTPRINT_DIMS",
]

_PASSES = (tracelint.run, locks.run, kernelcheck.run, scalecheck.run)


def analyze_file(path: str, text: str | None = None) -> list[Finding]:
    """All findings for one module (or CUDA source), suppressions applied,
    deduped."""
    src = SourceFile.parse(path, text)
    findings: list[Finding] = src.meta_findings()
    for run in _PASSES:
        findings.extend(run(src))
    src.apply_suppressions(findings)
    seen: set[tuple[str, str, int]] = set()
    out: list[Finding] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.code)):
        key = (f.code, f.path, f.line)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def _source_files(paths: list[str]) -> list[str]:
    """Python modules, and the CUDA sources of kernels/ directories."""
    out: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if not d.startswith((".", "__")))
            cuda = "kernels" in os.path.normpath(root).split(os.sep)
            out.extend(
                os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py") or (cuda and f.endswith(CUDA_SUFFIXES))
            )
    return out


def analyze_paths(paths: list[str]) -> list[Finding]:
    findings: list[Finding] = []
    for path in _source_files(paths):
        findings.extend(analyze_file(path))
    return findings
