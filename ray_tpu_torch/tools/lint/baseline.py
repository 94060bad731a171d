"""Checked-in baseline for grandfathered findings.

The baseline (`LINT_BASELINE_TORCH.json` at the repo root; the reference
analyzer's `LINT_BASELINE.json` beside it is its own and is never read
here) holds findings that were triaged as false positives — each entry carries a written `reason`.
New findings are NOT baselined automatically: `--write-baseline` stamps
them with a TODO reason that a human must replace before committing
(the gate test treats a TODO reason as a failure).

Entry shape (matching by `fingerprint`, which hashes rule + file +
enclosing scope + normalized source text, so entries survive line
drift):

    {
      "fingerprint": "1f2e3d...",
      "rule": "RTL201",
      "path": "ray_tpu_torch/llm/engine.py",
      "context": "LLMServer.check_health",
      "line": 1022,
      "summary": "self._wedged read without self._lock",
      "reason": "atomic bool read; taking the engine lock here would ..."
    }
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

BASELINE_FILENAME = "LINT_BASELINE_TORCH.json"
TODO_REASON = "TODO: triage — fix or replace this reason"


def load_baseline(path: Path) -> Dict[str, dict]:
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    return {e["fingerprint"]: e for e in data.get("findings", [])}


def save_baseline(path: Path, entries: List[dict]) -> None:
    payload = {
        "version": 1,
        "tool": "ray-tpu-torch lint",
        "findings": sorted(
            entries, key=lambda e: (e["path"], e.get("line", 0), e["rule"])
        ),
    }
    path.write_text(json.dumps(payload, indent=2) + "\n")


def entry_for(finding, reason: str = TODO_REASON) -> dict:
    return {
        "fingerprint": finding.fingerprint,
        "rule": finding.rule,
        "path": finding.path,
        "context": finding.context,
        "line": finding.line,
        "summary": finding.message.split(";")[0][:120],
        "reason": reason,
    }


def untriaged(baseline: Dict[str, dict]) -> List[dict]:
    """Entries whose reason was never written (the gate fails on these)."""
    return [
        e for e in baseline.values()
        if not e.get("reason") or e["reason"].startswith("TODO")
    ]
