"""`ray-tpu-torch lint` — CLI for the codebase-aware static analyzer.

    ray-tpu-torch lint [paths ...] [--rule ID] [--json] [--sarif]
                 [--baseline FILE] [--write-baseline] [--list-rules]
                 [--no-baseline] [--explain RULE] [--changed]

Exit codes: 0 — clean (every finding fixed, suppressed with a reason, or
baselined with a reason); 1 — active findings (or untriaged baseline
entries); 2 — usage/parse errors.

`--json` emits a machine-readable report (consumed by the dashboard and
tests). `version` is the SCHEMA version — bumped to 3 with the
diff-scoped scan (`files_checked` key; new keys never appear under an
old version number, so consumers can gate on it):

    {
      "version": 3,
      "schema": "ray-tpu-lint-report/3",
      "root": "/abs/repo",
      "paths": ["ray_tpu_torch"],
      "files_scanned": 240,
      "files_checked": 240,
      "duration_s": 1.8,
      "counts": {"active": 0, "baselined": 12, "suppressed": 4,
                 "parse_errors": 0, "stale_baseline": 0,
                 "untriaged_baseline": 0},
      "findings": [ {rule, name, family, path, line, col, context,
                     message, fingerprint}, ... ],
      "parse_errors": [ {...}, ... ],
      "baselined": [ {... , "reason": "..."}, ... ],
      "suppressed": [ {... , "reason": "..."}, ... ]
    }

`counts.active == len(findings)` always; unparseable files are reported
in their own `parse_errors` array (counted by `counts.parse_errors`).

`--sarif` emits SARIF 2.1.0 for CI annotation pipelines (GitHub code
scanning et al.): active findings as `warning` results, parse errors as
`error`, rule metadata (description + rationale) in the tool driver, and
the lint fingerprint under `partialFingerprints` so annotation dedup
survives line drift. Exit codes match the other modes.

`--explain RULE` prints the rule's rationale plus a minimal bad/good
example pair — the SAME snippets the fixture tests run, so the examples
can never drift from what the rule flags.

The reference analyzer's rules that read JAX programs are not ported:
`--list-rules` prints them under "not ported" with their reasons, and
`--rule` or `--explain` on one exits 2 printing its reason.

`--changed` scopes the scan to the files changed vs git HEAD (tracked
modifications plus untracked .py files) AND their reverse import
dependents from the project model — everything is still parsed so the
cross-module symbol table sees the whole tree, but rules run only on
the diff closure. That is the pre-commit loop: `make lint-changed`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import List, Optional, Set

from ray_tpu_torch.tools.lint import NOT_PORTED, not_ported
from ray_tpu_torch.tools.lint import baseline as baseline_mod
from ray_tpu_torch.tools.lint.core import (
    all_rules,
    find_repo_root,
    lint_paths,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ray-tpu-torch lint",
        description=(
            "Codebase-aware static analyzer of ray_tpu_torch: actor "
            "races, async deadlocks, wall-clock arithmetic, resource "
            "hygiene, actor call-graph deadlocks, int8 pool pairing"
        ),
    )
    parser.add_argument(
        "paths", nargs="*", default=["ray_tpu_torch"],
        help="files or directories to scan (default: ray_tpu_torch)",
    )
    parser.add_argument(
        "--rule", action="append", default=None, metavar="ID",
        help="run only this rule id/name (repeatable)",
    )
    parser.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    parser.add_argument(
        "--baseline", default=None, metavar="FILE",
        help="baseline file (default: LINT_BASELINE_TORCH.json at the repo root)",
    )
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline (report everything)",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help=(
            "write current active findings into the baseline with TODO "
            "reasons (replace them before committing)"
        ),
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    parser.add_argument(
        "--sarif", action="store_true",
        help="SARIF 2.1.0 output (CI annotations / external tooling)",
    )
    parser.add_argument(
        "--explain", default=None, metavar="RULE",
        help="print a rule's rationale + minimal bad/good example",
    )
    parser.add_argument(
        "--changed", action="store_true",
        help=(
            "check only files changed vs git HEAD plus their reverse "
            "import dependents (the whole tree is still parsed for the "
            "cross-module pass)"
        ),
    )
    return parser


def _git_changed_files(root: Path) -> Optional[Set[str]]:
    """LINT-root-relative posix paths of changed .py files: tracked
    changes vs HEAD plus untracked (not ignored) files. None when git
    is unavailable or `root` is not inside a work tree. `--relative`
    matters: the lint root (pyproject.toml) may be a SUBDIRECTORY of
    the git toplevel, and module relpaths are computed against the lint
    root — without it, diff paths come back toplevel-relative, nothing
    matches, and a monorepo pre-commit run would silently check zero
    files."""
    out: Set[str] = set()
    for cmd in (
        ["git", "-C", str(root), "diff", "--name-only", "--relative",
         "HEAD"],
        ["git", "-C", str(root), "ls-files", "--others",
         "--exclude-standard"],
    ):
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, check=True
            )
        except (OSError, subprocess.CalledProcessError):
            return None
        out.update(
            line.strip() for line in proc.stdout.splitlines()
            if line.strip().endswith(".py")
        )
    return out


SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)


def _sarif_result(finding, level: str) -> dict:
    return {
        "ruleId": finding.rule,
        "level": level,
        "message": {"text": f"{finding.message} ({finding.context})"},
        "locations": [
            {
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": finding.path,
                        "uriBaseId": "SRCROOT",
                    },
                    "region": {
                        "startLine": max(finding.line, 1),
                        "startColumn": finding.col + 1,
                    },
                }
            }
        ],
        # The lint fingerprint hashes rule+file+scope+normalized source,
        # so CI annotation dedup survives line drift exactly like the
        # checked-in baseline does.
        "partialFingerprints": {
            "rayTpuLint/v1": finding.fingerprint or "",
        },
    }


def sarif_report(result, root: Path) -> dict:
    rules_meta = [
        {
            "id": rule.id,
            "name": rule.name,
            "shortDescription": {"text": rule.description},
            "fullDescription": {
                "text": rule.rationale or rule.description
            },
            "properties": {"family": rule.family},
        }
        for rule in all_rules()
    ]
    results = [_sarif_result(f, "warning") for f in result.findings]
    results.extend(
        _sarif_result(f, "error") for f in result.parse_errors
    )
    return {
        "$schema": SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "ray-tpu-torch-lint",
                        "informationUri": (
                            "https://github.com/ray-tpu/ray-tpu"
                        ),
                        "rules": rules_meta,
                    }
                },
                "originalUriBaseIds": {
                    "SRCROOT": {"uri": root.resolve().as_uri() + "/"}
                },
                "results": results,
            }
        ],
    }


def _refuse_dropped(rule_id: str) -> bool:
    """Print why a rule of the reference analyzer is not ported; True
    when `rule_id` names one."""
    dropped = not_ported(rule_id)
    if dropped is None:
        return False
    rid, name, reason = dropped
    print(f"ray-tpu-torch lint: {rid} {name} is not ported: {reason}",
          file=sys.stderr)
    return True


def explain_rule(rule_id: str) -> int:
    import textwrap

    if _refuse_dropped(rule_id):
        return 2
    for rule in all_rules():
        if rule.id != rule_id and rule.name != rule_id:
            continue
        print(f"{rule.id}  {rule.name}  [{rule.family}]")
        print(f"\n{rule.description}\n")
        if rule.rationale:
            print("Why:")
            print(textwrap.fill(rule.rationale, width=72,
                                initial_indent="  ",
                                subsequent_indent="  "))
        if rule.bad_example:
            print("\nFires on:\n")
            print(textwrap.indent(
                textwrap.dedent(rule.bad_example).strip(), "    "))
        if rule.good_example:
            print("\nClean form:\n")
            print(textwrap.indent(
                textwrap.dedent(rule.good_example).strip(), "    "))
        return 0
    print(f"ray-tpu-torch lint: no such rule: {rule_id}", file=sys.stderr)
    return 2


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        for rule in all_rules():
            print(f"{rule.id}  {rule.name:24s} [{rule.family}] "
                  f"{rule.description}")
        print("\nnot ported (the reference analyzer's rules that read "
              "JAX programs):")
        for rid, (name, reason) in sorted(NOT_PORTED.items()):
            print(f"{rid}  {name:24s} {reason}")
        return 0

    if args.explain:
        return explain_rule(args.explain)

    if args.rule and any(_refuse_dropped(r) for r in args.rule):
        return 2

    paths = [Path(p) for p in args.paths]
    missing = [p for p in paths if not p.exists()]
    if missing:
        print(f"ray-tpu-torch lint: no such path: {missing[0]}", file=sys.stderr)
        return 2
    root = find_repo_root(paths[0])
    baseline_path = (
        Path(args.baseline)
        if args.baseline
        else root / baseline_mod.BASELINE_FILENAME
    )
    baseline = (
        {} if args.no_baseline else baseline_mod.load_baseline(baseline_path)
    )

    changed: Optional[Set[str]] = None
    if args.changed:
        changed = _git_changed_files(root)
        if changed is None:
            print(
                "ray-tpu-torch lint: --changed needs a git work tree at "
                f"{root}", file=sys.stderr,
            )
            return 2

    result = lint_paths(
        paths, rule_ids=args.rule, baseline=baseline, root=root,
        changed_only=changed,
    )

    if args.write_baseline:
        # Start from the file on disk, not the (possibly --no-baseline'd
        # or filtered) view used for the scan: entries outside this run's
        # scope must survive, and already-written reasons must never be
        # re-stamped with TODO.
        existing = baseline_mod.load_baseline(baseline_path)
        for f, _ in result.baselined:
            if f.fingerprint in existing:
                existing[f.fingerprint]["line"] = f.line
        new = 0
        for f in result.findings:
            prior = existing.get(f.fingerprint)
            if prior is not None:
                prior["line"] = f.line
            else:
                existing[f.fingerprint] = baseline_mod.entry_for(f)
                new += 1
        # Drop stale entries (the finding no longer exists) — but ONLY
        # those this run could have re-produced: an entry is in scope
        # exactly when its rule was in the scanned rule set AND its
        # file was in the CHECKED set (rules actually ran on it). A
        # scan scoped by path, --rule or --changed must not discard the
        # rest of the baseline — a narrowed run re-fingerprints only
        # what it checked, so everything else (other families, other
        # files, their written reasons) survives verbatim. A file that
        # failed to PARSE this run produced no findings at all, so its
        # triaged entries survive too.
        produced = {f.fingerprint for f in result.findings} | {
            f.fingerprint for f, _ in result.baselined
        }
        parse_failed = {f.path for f in result.parse_errors}
        wanted = set(args.rule) if args.rule else None
        scanned_rules = {
            r.id for r in all_rules()
            if wanted is None or r.id in wanted or r.name in wanted
        }
        # The meta findings are produced outside the registry: RTL002
        # on every run, RTL003 only on full-registry runs — their stale
        # entries are droppable exactly then.
        scanned_rules.add("RTL002")
        if wanted is None:
            scanned_rules.add("RTL003")

        def in_scope(entry: dict) -> bool:
            return (
                entry.get("rule") in scanned_rules
                and entry.get("path") in result.checked_relpaths
            )

        entries = [
            e for fp, e in existing.items()
            if fp in produced
            or e["path"] in parse_failed
            or not in_scope(e)
        ]
        baseline_mod.save_baseline(baseline_path, entries)
        print(
            f"wrote {len(entries)} entries to {baseline_path} "
            f"({new} new with TODO reasons)"
        )
        return 0

    untriaged = baseline_mod.untriaged(
        {
            f.fingerprint: baseline[f.fingerprint]
            for f, _ in result.baselined
            if f.fingerprint in baseline
        }
    )

    if args.sarif:
        print(json.dumps(sarif_report(result, root), indent=2))
    elif args.json:
        report = {
            "version": 3,
            "schema": "ray-tpu-lint-report/3",
            "root": str(root),
            "paths": [str(p) for p in paths],
            "files_scanned": result.files_scanned,
            "files_checked": len(result.checked_relpaths),
            "duration_s": round(result.duration_s, 3),
            "counts": {
                "active": len(result.findings),
                "baselined": len(result.baselined),
                "suppressed": len(result.suppressed),
                "parse_errors": len(result.parse_errors),
                "stale_baseline": len(result.stale_baseline),
                "untriaged_baseline": len(untriaged),
            },
            "findings": [f.to_dict() for f in result.findings],
            "parse_errors": [f.to_dict() for f in result.parse_errors],
            "baselined": [
                {**f.to_dict(), "reason": reason}
                for f, reason in result.baselined
            ],
            "suppressed": [
                {**f.to_dict(), "reason": reason}
                for f, reason in result.suppressed
            ],
        }
        print(json.dumps(report, indent=2))
    else:
        for f in result.parse_errors + result.findings:
            print(
                f"{f.path}:{f.line}:{f.col}: {f.rule} {f.name} "
                f"[{f.family}] {f.message} ({f.context})"
            )
        for entry in untriaged:
            print(
                f"{entry['path']}:{entry.get('line', 0)}: {entry['rule']} "
                f"baseline entry has no written reason ({entry['reason']!r})"
            )
        scope = (
            f"{len(result.checked_relpaths)} changed(+dependents) of "
            f"{result.files_scanned} files"
            if args.changed
            else f"{result.files_scanned} files"
        )
        summary = (
            f"{len(result.findings)} finding(s), "
            f"{len(result.baselined)} baselined, "
            f"{len(result.suppressed)} suppressed, "
            f"{len(result.parse_errors)} parse error(s) in "
            f"{scope} "
            f"({result.duration_s:.2f}s)"
        )
        if result.stale_baseline:
            summary += (
                f"; {len(result.stale_baseline)} stale baseline entr"
                f"{'y' if len(result.stale_baseline) == 1 else 'ies'} "
                "(regenerate with --write-baseline)"
            )
        print(summary)

    # Stale entries fail too: the CI gate rejects them, so a local run
    # must not report clean and then break in CI.
    if (
        result.findings
        or result.parse_errors
        or untriaged
        or result.stale_baseline
    ):
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
