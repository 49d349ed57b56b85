"""Structured findings + the per-rule allowlist.

Every rule emits :class:`Finding` records with a stable rule ID; the CLI
filters them through an allowlist file before deciding red/green.  The
allowlist line format is::

    RULE:target-glob    # reason (required — an unexplained waiver is a bug)

matched with ``fnmatch`` against ``"{rule}:{target}"``, e.g.::

    AST103:src/repro_torch/serving/clock.py:*   # WallClock IS the real-time shim
"""

from __future__ import annotations

import fnmatch
from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class Finding:
    rule: str       # stable rule ID, e.g. "HLO001"
    target: str     # dispatch entry ("decode_step_paged@kv1") or file:line
    message: str    # names the offending op / line / byte figure

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.target}"

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass(frozen=True)
class AllowlistEntry:
    pattern: str    # "RULE:target-glob"
    reason: str

    def matches(self, finding: Finding) -> bool:
        return fnmatch.fnmatch(finding.key, self.pattern)


def parse_allowlist(text: str) -> list[AllowlistEntry]:
    entries = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        pat, _, reason = line.partition("#")
        pat = pat.strip()
        reason = reason.strip()
        if ":" not in pat:
            raise ValueError(
                f"allowlist line {lineno}: expected RULE:target-glob, "
                f"got {pat!r}")
        if not reason:
            raise ValueError(
                f"allowlist line {lineno}: a '# reason' is required")
        entries.append(AllowlistEntry(pat, reason))
    return entries


def load_allowlist(path) -> list[AllowlistEntry]:
    with open(path) as f:
        return parse_allowlist(f.read())


def apply_allowlist(findings, allowlist):
    """Split findings into (active, waived) under the allowlist."""
    active, waived = [], []
    for f in findings:
        if any(e.matches(f) for e in allowlist):
            waived.append(f)
        else:
            active.append(f)
    return active, waived
