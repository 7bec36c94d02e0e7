"""Lint findings and reports (counterpart of
``paddle_tpu.analysis.report``).

Each :class:`Finding` carries a ``family:rule`` code, a severity, a
message and the anchor it is about (a param name, a manifest entry, a
feed key). A :class:`LintReport` collects findings, deduplicated by the
finding's stable :attr:`Finding.fingerprint` (``family:rule|subject|
shape``): a repeated identical finding bumps :attr:`Finding.count`.

A report is also a *collector*: while one is installed through
:func:`collect_into`, cooperating subsystems (``parallel.sharding``'s
rule-drop diagnostics) add findings to it instead of warning, so one
check gathers everything the code it ran touched.

For a CI gate: a baseline suppression file (:func:`load_baseline`,
:func:`write_baseline`, :func:`new_findings`), per-code severity
overrides (:func:`apply_severity`) and a SARIF 2.1.0 emitter
(:func:`to_sarif`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import warnings
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..core.errors import EnforceError, enforce

SEVERITIES = ("info", "warning", "error")
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}

# data keys that participate in the fingerprint's shape signature: the
# STRUCTURAL identity of a finding (what it is about), never the
# measurements (byte counts, fractions) that legitimately drift run to
# run and would make baseline keys unstable. "path" (the loop nesting a
# collective sits in) is structural too: without it every
# `collective:in-scan` finding of a program shares one fingerprint, and a
# baseline accepting one loop's exchange would silently suppress a new
# one in a different loop
_FINGERPRINT_DATA_KEYS = ("shape", "shapes", "dtype", "axis", "bucket",
                          "buckets", "expected", "got", "path")


class LintError(EnforceError):
    """Raised by :meth:`LintReport.enforce_clean`."""

    def __init__(self, report: "LintReport", level: str):
        self.report = report
        super().__init__(
            f"program lint failed at level {level!r}:\n{report.render()}")


class LintWarning(UserWarning):
    """Category for findings surfaced through the warnings module
    (:meth:`LintReport.emit_warnings`)."""


@dataclasses.dataclass
class Finding:
    """One diagnostic: ``code`` is ``family:rule`` (e.g.
    ``"collective:in-scan"``), ``where`` names the anchor (parameter,
    equation, feed key), ``data`` holds rule-specific measurements
    (comm-byte estimates, shapes). ``count`` is the number of identical
    occurrences merged into this entry (reports dedupe on
    :attr:`fingerprint`)."""

    code: str
    severity: str
    message: str
    where: str = ""
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)
    count: int = 1

    def __post_init__(self):
        assert self.severity in SEVERITIES, self.severity

    @property
    def fingerprint(self) -> str:
        """Stable identity key ``family:rule|subject|shape``: the code,
        the anchor, and the structural data keys (shapes/dtypes/axes —
        never byte measurements). Two findings with the same fingerprint
        are THE SAME finding (dedupe merges them; baselines suppress by
        this key); the message text is free to improve between versions
        without invalidating every baseline."""
        sig = ",".join(f"{k}={self.data[k]!r}"
                       for k in _FINGERPRINT_DATA_KEYS if k in self.data)
        return f"{self.code}|{self.where}|{sig}"

    def __str__(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        mult = f" (x{self.count})" if self.count > 1 else ""
        return (f"{self.severity.upper():<8} {self.code:<28}{loc} "
                f"{self.message}{mult}")


class LintReport:
    """Ordered collection of findings for one checked program,
    deduplicated by :attr:`Finding.fingerprint`: re-adding an identical
    finding (startup lint + an explicit ``check_trainer`` re-run merged
    via :meth:`extend`, or a rule that fires once per trace of the same
    layer) bumps ``count`` on the existing entry instead of
    accumulating — baselines need exactly one stable key per finding."""

    def __init__(self, subject: str = "program"):
        self.subject = subject
        self.findings: List[Finding] = []
        self._by_fingerprint: Dict[Tuple[str, str], Finding] = {}

    # -- building ----------------------------------------------------------
    def add(self, code: str, severity: str, message: str, where: str = "",
            **data) -> Finding:
        return self.merge(Finding(code=code, severity=severity,
                                  message=message, where=where,
                                  data=dict(data)))

    def merge(self, f: Finding) -> Finding:
        """Add ``f``, deduplicating by fingerprint (count accumulates).
        A same-fingerprint finding at a *different* severity is kept
        separate — severity overrides must never silently swallow an
        escalated duplicate."""
        key = (f.fingerprint, f.severity)
        existing = self._by_fingerprint.get(key)
        if existing is not None:
            existing.count += f.count
            return existing
        self.findings.append(f)
        self._by_fingerprint[key] = f
        return f

    def extend(self, other: "LintReport") -> "LintReport":
        for f in other.findings:
            self.merge(dataclasses.replace(f, data=dict(f.data)))
        return self

    # -- querying ----------------------------------------------------------
    def codes(self) -> set:
        return {f.code for f in self.findings}

    def by_code(self, code: str) -> List[Finding]:
        return [f for f in self.findings if f.code == code]

    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            out[f.severity] += 1
        return out

    def at_least(self, level: str) -> List[Finding]:
        rank = _SEV_RANK[level]
        return [f for f in self.findings if _SEV_RANK[f.severity] >= rank]

    def ok(self, level: str = "warning") -> bool:
        """Clean at ``level``: no findings of that severity or above."""
        return not self.at_least(level)

    # -- output ------------------------------------------------------------
    def render(self, level: str = "info") -> str:
        shown = self.at_least(level)
        if not shown:
            return f"{self.subject}: clean (no findings at level >= {level})"
        c = self.counts()
        head = (f"{self.subject}: {len(self.findings)} finding(s) "
                f"({c['error']} error, {c['warning']} warning, {c['info']} info)")
        return "\n".join([head] + [f"  {f}" for f in shown])

    def to_dict(self) -> Dict[str, Any]:
        return {
            "subject": self.subject,
            "counts": self.counts(),
            "findings": [dict(dataclasses.asdict(f),
                              fingerprint=f.fingerprint)
                         for f in self.findings],
        }

    def enforce_clean(self, level: str = "warning") -> "LintReport":
        """Raise :class:`LintError` unless :meth:`ok` at ``level``."""
        if not self.ok(level):
            raise LintError(self, level)
        return self

    def emit_warnings(self, level: str = "warning") -> "LintReport":
        """Surface findings at/above ``level`` as :class:`LintWarning`."""
        for f in self.at_least(level):
            warnings.warn(str(f), LintWarning, stacklevel=2)
        return self

    def __len__(self) -> int:
        return len(self.findings)

    def __repr__(self) -> str:
        return f"<LintReport {self.subject!r}: {self.counts()}>"


# --------------------------------------------------------------------------
# collector context — lets non-analysis subsystems contribute findings
# --------------------------------------------------------------------------

_tls = threading.local()


def active_report() -> Optional[LintReport]:
    """The innermost report installed by :func:`collect_into`, or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def collect_into(report: LintReport):
    """Route cooperating subsystems' diagnostics (e.g.
    ``parallel.sharding._warn_drop``) into ``report`` for the duration
    of the block instead of the warnings module."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(report)
    try:
        yield report
    finally:
        stack.pop()


# --------------------------------------------------------------------------
# CI surface: severity overrides, baseline suppression, SARIF
# --------------------------------------------------------------------------


def apply_severity(report: LintReport,
                   overrides: Optional[Dict[str, str]] = None) -> LintReport:
    """Re-severity findings per a config mapping: keys are exact codes
    (``"moe:capacity"``) or whole families (``"collective"``); exact
    codes win. Lets a deployment promote a lint to a gate-blocking
    error (or demote a known-noisy one) without forking the rules."""
    if not overrides:
        return report
    for sev in overrides.values():
        enforce(sev in SEVERITIES,
                f"severity override must be one of {SEVERITIES}, got {sev!r}")
    old = report.findings
    report.findings = []
    report._by_fingerprint = {}
    for f in old:
        sev = overrides.get(f.code) or overrides.get(f.code.split(":")[0])
        if sev:
            f.severity = sev
        report.merge(f)   # re-merge: overrides may collapse severity splits
    return report


BASELINE_VERSION = 1


def baseline_key(subject: str, finding: Finding) -> str:
    """The key a finding is suppressed under: the checked subject (zoo
    config id / program name) scoping the finding's fingerprint — the
    same finding on two different programs is two baseline entries."""
    return f"{subject}::{finding.fingerprint}"


def write_baseline(path: str,
                   reports: Iterable[Tuple[str, LintReport]]) -> Dict[str, Any]:
    """Write a baseline suppression file covering every finding in
    ``reports`` (an iterable of ``(subject, report)``). Committing the
    file freezes today's findings as accepted debt; the gate then fails
    only on NEW fingerprints."""
    entries: Dict[str, Any] = {}
    for subject, report in reports:
        for f in report.findings:
            key = baseline_key(subject, f)
            prev = entries.get(key)
            entries[key] = {
                "code": f.code,
                "severity": f.severity,
                "where": f.where,
                "count": f.count + (prev["count"] if prev else 0),
            }
    doc = {"version": BASELINE_VERSION,
           "tool": "paddle_tpu_torch.analysis",
           "baseline": dict(sorted(entries.items()))}
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return doc


def load_baseline(path: Optional[str]) -> Dict[str, Any]:
    """Parse a baseline file → {baseline_key: entry}. ``None`` or a
    missing file reads as the empty baseline (every finding is new)."""
    if not path:
        return {}
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        return {}
    enforce(isinstance(doc, dict) and isinstance(doc.get("baseline"), dict),
            f"baseline file {path!r} is not a "
            "{'version':..,'baseline':{...}} document")
    ver = doc.get("version")
    enforce(isinstance(ver, int) and ver <= BASELINE_VERSION,
            f"baseline file {path!r} has version {ver!r}; this build reads "
            f"<= {BASELINE_VERSION}")
    return doc["baseline"]


def new_findings(subject: str, report: LintReport,
                 baseline: Dict[str, Any],
                 level: str = "warning") -> List[Finding]:
    """Findings at/above ``level`` whose baseline key is NOT suppressed
    — what a CI gate fails on. Suppression is by key presence: a
    baselined finding whose count grew is still suppressed (counts are
    measurements, not identity)."""
    return [f for f in report.at_least(level)
            if baseline_key(subject, f) not in baseline]


_SARIF_LEVEL = {"info": "note", "warning": "warning", "error": "error"}


def to_sarif(reports: Iterable[Tuple[str, LintReport]]) -> Dict[str, Any]:
    """Render ``(subject, report)`` pairs as one SARIF 2.1.0 run —
    the interchange format CI annotators (GitHub code scanning et al.)
    ingest. Rules are the distinct finding codes; each result carries
    the stable fingerprint under ``partialFingerprints`` so re-runs
    update rather than duplicate annotations."""
    rules: Dict[str, Dict[str, Any]] = {}
    results: List[Dict[str, Any]] = []
    for subject, report in reports:
        for f in report.findings:
            rules.setdefault(f.code, {
                "id": f.code,
                "shortDescription": {"text": f.code},
                "defaultConfiguration": {
                    "level": _SARIF_LEVEL[f.severity]},
            })
            results.append({
                "ruleId": f.code,
                "level": _SARIF_LEVEL[f.severity],
                "message": {"text": f"[{subject}] {f.message}"},
                "partialFingerprints": {
                    "paddleTpuLint/v1": baseline_key(subject, f)},
                "occurrenceCount": f.count,
                "locations": [{
                    "logicalLocations": [{
                        "name": f.where or subject,
                        "fullyQualifiedName": f"{subject}::{f.where}"
                                              if f.where else subject,
                    }],
                }],
            })
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "paddle_tpu_torch.analysis",
                "informationUri": "https://example.invalid/paddle_tpu_torch",
                "rules": [rules[k] for k in sorted(rules)],
            }},
            "results": results,
        }],
    }
