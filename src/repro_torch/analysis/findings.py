"""Finding model + baseline file for the port's static verifier.

Counterpart of ``repro.analysis.findings``, kept to its format: the two
packages write byte-identical baseline files for the same keys and each
reads the other's.

A `Finding` is one rule violation at one source location. Its *baseline
key* is ``(rule, path, snippet)`` — the stripped source line text rather
than the line number — so grandfathered findings survive unrelated edits
above them and go stale (forcing a baseline refresh) exactly when the
offending line itself changes.

The baseline file is JSON::

    {"version": 1,
     "findings": [{"rule": "R1", "path": "src/.../x.py",
                   "snippet": "int(count.max())"}]}

and is checked in next to the package (``baseline.json``); regenerate
with ``python -m repro_torch.analysis --layer lint --write-baseline``
after consciously grandfathering a finding.
"""

from __future__ import annotations

import dataclasses
import json

__all__ = ["Finding", "load_baseline", "write_baseline"]

BASELINE_VERSION = 1


@dataclasses.dataclass
class Finding:
    """One rule violation at one source location."""
    rule: str      # rule id, e.g. "R1"
    path: str      # repo-relative file path
    line: int      # 1-based line number
    col: int       # 0-based column
    message: str   # what was found
    hint: str      # the rule's fix-hint
    snippet: str   # stripped source line (the baseline key component)
    suppressed: bool = False   # a `# skylint: disable=<rule>` covers it
    baselined: bool = False    # grandfathered by the baseline file

    @property
    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.snippet)

    @property
    def active(self) -> bool:
        """Counts toward the gate (not suppressed, not baselined)."""
        return not (self.suppressed or self.baselined)

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "hint": self.hint, "snippet": self.snippet,
                "suppressed": self.suppressed,
                "baselined": self.baselined}

    def __str__(self) -> str:
        tag = (" [suppressed]" if self.suppressed
               else " [baselined]" if self.baselined else "")
        return f"{self.rule} {self.path}:{self.line}: {self.message}{tag}"


def load_baseline(path: str) -> set[tuple[str, str, str]]:
    """Baseline keys from a baseline JSON file (empty set if absent)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return set()
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(f"unsupported baseline version in {path}: "
                         f"{data.get('version')!r}")
    return {(e["rule"], e["path"], e["snippet"])
            for e in data.get("findings", [])}


def write_baseline(findings, path: str) -> int:
    """Write the (deduplicated) keys of ``findings`` as the new baseline;
    returns the number of entries."""
    keys = sorted({f.key for f in findings})
    entries = [{"rule": r, "path": p, "snippet": s} for r, p, s in keys]
    with open(path, "w") as f:
        json.dump({"version": BASELINE_VERSION, "findings": entries},
                  f, indent=1)
        f.write("\n")
    return len(entries)
