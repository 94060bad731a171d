"""Tests for `ray-tpu-torch lint` (ray_tpu_torch/tools/lint), the port of
the reference analyzer (ray_tpu/tools/lint) aimed at ray_tpu_torch/.

Parity first: every carried rule gives what the reference's gives —
(rule, line, col, context, message, fingerprint) — on the reference's own
--explain examples and on the fixtures of tests/test_lint.py for its
family, read from that file, with `ray_tpu` renamed to `ray_tpu_torch`.
Then the reference's cases for the carried families, the meta rules,
suppressions, the baseline, `--changed`, `--json` and `--sarif`, run on
the port; the registry against the reference's (carried plus not ported,
id for id); the actor index on both trees; RTL804 on torch pools,
including mutated copies of the port's model runner; the port's hand-off
lock as a lock; and the gate: the port's tool on ray_tpu_torch/ against
LINT_BASELINE_TORCH.json is clean.
"""

from __future__ import annotations

import ast
import json
import re
import shutil
import textwrap
import time
from pathlib import Path

import pytest

from ray_tpu_torch.tools.lint import (
    NOT_PORTED,
    all_rules,
    lint_paths,
    lint_source,
)
from ray_tpu_torch.tools.lint import baseline as baseline_mod
from ray_tpu_torch.tools.lint.cli import main as lint_main
from ray_tpu_torch.tools.lint.core import lint_sources

pytestmark = pytest.mark.lint

REPO_ROOT = Path(__file__).resolve().parent.parent


def rules_of(findings):
    return [f.rule for f in findings]


def lint(src, **kwargs):
    return lint_source(textwrap.dedent(src), **kwargs)


def lint_files(files, **kwargs):
    """Multi-module fixture harness: {relpath: source} through one
    project (symbol table / call graph / actor index span the dict)."""
    return lint_sources(
        {p: textwrap.dedent(s) for p, s in files.items()}, **kwargs
    )


def to_port(source: str) -> str:
    """A reference fixture as the port's: `ray_tpu` renamed."""
    return re.sub(r"\bray_tpu\b", "ray_tpu_torch", source)


# ---------------------------------------------------------------------------
# The reference's cases for the carried families, on the port
# ---------------------------------------------------------------------------


def test_blocking_get_in_async_def_flagged():
    findings = lint(
        """
        import ray_tpu_torch

        async def handler(ref):
            return ray_tpu_torch.get(ref)
        """
    )
    assert "RTL101" in rules_of(findings)


def test_blocking_calls_via_alias_and_result():
    findings = lint(
        """
        import time
        from ray_tpu_torch import api as ray

        class A:
            async def poll(self, ref, fut):
                time.sleep(1.0)
                x = ray.get(ref)
                y = fut.result()
                return x, y
        """
    )
    assert rules_of(findings).count("RTL101") == 3


def test_awaited_and_offloaded_calls_not_flagged():
    findings = lint(
        """
        import asyncio, time

        async def ok(loop, pool, ref):
            await asyncio.sleep(0.1)
            # Shipped off-loop: the sanctioned pattern.
            x = await loop.run_in_executor(None, lambda: do_get(ref))
            y = await loop.run_in_executor(pool, time.sleep, 1.0)
            return x, y
        """
    )
    assert "RTL101" not in rules_of(findings)


def test_nested_sync_def_inside_async_not_flagged():
    findings = lint(
        """
        import time

        async def outer(pool):
            def blocking():  # runs wherever it's submitted, not on the loop
                time.sleep(1.0)
            return pool.submit(blocking)
        """
    )
    assert "RTL101" not in rules_of(findings)


def test_threading_event_wait_in_async_def_flagged():
    findings = lint(
        """
        import threading

        class A:
            def __init__(self):
                self._done = threading.Event()

            async def wait_done(self):
                self._done.wait()
        """
    )
    assert "RTL101" in rules_of(findings)


def test_await_while_holding_threading_lock_flagged():
    findings = lint(
        """
        import threading

        class A:
            def __init__(self):
                self._lock = threading.Lock()

            async def bad(self, coro):
                with self._lock:
                    await coro

            async def good(self, coro):
                with self._lock:
                    pass
                await coro
        """
    )
    assert rules_of(findings).count("RTL102") == 1
    assert findings[0].context.endswith("bad")


def test_await_under_local_lock_and_async_gen():
    findings = lint(
        """
        import threading

        async def agen(items):
            lock = threading.Lock()
            for item in items:
                with lock:
                    yield await item
        """
    )
    assert "RTL102" in rules_of(findings)


def test_unawaited_local_coroutine_flagged():
    findings = lint(
        """
        class A:
            async def _push(self):
                pass

            def kick(self):
                self._push()

            async def ok(self):
                await self._push()

        async def helper():
            pass

        def fire():
            helper()
        """
    )
    assert rules_of(findings).count("RTL402") == 2


LOCKED_CLASS = """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = []
            self._count = 0

        def add(self, x):
            with self._lock:
                self._items.append(x)
                self._count += 1

        def bad_read(self):
            return len(self._items)

        def good_read(self):
            with self._lock:
                return len(self._items)

        def _sum_locked(self):
            return sum(self._items)

        def _helper(self):
            \"\"\"Caller must hold self._lock.\"\"\"
            return list(self._items)
"""


def test_lock_coverage_flags_bare_access_only():
    findings = lint(LOCKED_CLASS)
    assert rules_of(findings) == ["RTL201"]
    assert findings[0].context.endswith("bad_read")
    assert "_items" in findings[0].message


def test_bare_attribute_expression_read_flagged():
    """Regression: a guarded attribute that IS the whole expression
    (`return self._x`, `if self._x:`) was misclassified as nested-def
    and never recorded — the most common bare-read shapes."""
    findings = lint(
        """
        import threading

        class Pool:
            def __init__(self):
                self._lock = threading.Lock()
                self._count = 0
                self._open = True

            def add(self):
                with self._lock:
                    self._count += 1
                    self._open = False

            def peek(self):
                return self._count

            def gate(self):
                if self._open:
                    return "open"
                return "closed"
        """
    )
    assert rules_of(findings) == ["RTL201", "RTL201"]
    assert {f.context.split(".")[-1] for f in findings} == {"peek", "gate"}


def test_condition_alias_counts_as_same_lock():
    findings = lint(
        """
        import threading

        class Q:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition(self._lock)
                self._queue = []

            def put(self, x):
                with self._cv:
                    self._queue.append(x)
                    self._cv.notify()

            def drain(self):
                with self._lock:
                    out, self._queue = self._queue, []
                    return out
        """
    )
    assert "RTL201" not in rules_of(findings)


def test_unguarded_attrs_and_init_not_flagged():
    findings = lint(
        """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._config = {"a": 1}   # never mutated under the lock
                self._state = []

            def read_config(self):
                return self._config["a"]

            def mutate(self):
                with self._lock:
                    self._state.append(1)
        """
    )
    assert "RTL201" not in rules_of(findings)


def test_setup_style_lock_construction_exempt():
    # A method that CREATES the lock is init: nothing contends yet.
    findings = lint(
        """
        import threading

        class Algo:
            def setup(self):
                self._lock = threading.Lock()
                self._updates = 0

            def bump(self):
                with self._lock:
                    self._updates += 1
        """
    )
    assert "RTL201" not in rules_of(findings)


def test_nested_callback_access_not_flagged():
    findings = lint(
        """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0

            def inc(self):
                with self._lock:
                    self._n += 1

            def make_cb(self):
                def cb():
                    return self._n  # runs on another thread; out of scope
                return cb
        """
    )
    assert "RTL201" not in rules_of(findings)


def test_manual_acquire_flagged():
    findings = lint(
        """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def bad(self):
                self._lock.acquire()
                do_something()
                self._lock.release()
        """
    )
    assert "RTL202" in rules_of(findings)


def test_wallclock_deadline_and_duration_flagged():
    findings = lint(
        """
        import time

        def wait_for(pred, timeout):
            deadline = time.time() + timeout
            while time.time() < deadline:
                if pred():
                    return True
            return False

        def timed(fn):
            t0 = time.time()
            fn()
            return time.time() - t0
        """
    )
    assert rules_of(findings).count("RTL302") == 2


def test_monotonic_deadline_arithmetic_pinned():
    """The overload control plane derives per-request end-to-end
    deadlines as `time.monotonic() + timeout` and enforces them against
    time.monotonic() — this fixture pins the idiom clean while its
    wall-clock twin stays flagged, so deadline arithmetic can never
    drift onto a clock that steps under NTP."""
    findings = lint(
        """
        import time

        def submit_ok(timeout_s):
            deadline_s = time.monotonic() + timeout_s
            return time.monotonic() >= deadline_s

        def submit_bad(timeout_s):
            deadline_s = time.time() + timeout_s
            return time.time() >= deadline_s
        """
    )
    assert rules_of(findings).count("RTL302") == 1


def test_wallclock_identity_not_flagged():
    findings = lint(
        """
        import time

        def stamp(record):
            record["time"] = time.time()
            return record

        def duration_ok():
            t0 = time.perf_counter()
            return time.perf_counter() - t0
        """
    )
    assert "RTL302" not in rules_of(findings)


def test_dropped_object_ref_flagged_and_bound_ok():
    findings = lint(
        """
        def fire(handle):
            handle.ping.remote()

        def keep(handle):
            ref = handle.ping.remote()
            return ref
        """
    )
    assert rules_of(findings) == ["RTL401"]


def test_cleared_before_commit_flagged_and_fixed_form_ok():
    findings = lint(
        """
        class Engine:
            def bad(self, seq):
                src, dst = seq.pending_copy
                seq.pending_copy = None
                self.runner.copy_block(src, dst)
                self.allocator.free([src])

            def good(self, seq):
                src, dst = seq.pending_copy
                self.runner.copy_block(src, dst)
                self.allocator.free([src])
                seq.pending_copy = None
        """
    )
    assert rules_of(findings) == ["RTL403"]
    assert findings[0].context.endswith("bad")


def test_leaky_acquire_flagged_and_try_ok():
    findings = lint(
        """
        class S:
            def bad(self, n):
                blocks = self.allocator.allocate(n)
                self.compute(blocks)
                self.allocator.free(blocks)

            def good(self, n):
                blocks = self.allocator.allocate(n)
                try:
                    self.compute(blocks)
                finally:
                    self.allocator.free(blocks)
        """
    )
    rtl404 = [f for f in findings if f.rule == "RTL404"]
    assert len(rtl404) == 1 and rtl404[0].context.endswith("bad")


def test_leaky_acquire_kv_fabric_restore_path_fixture():
    """KV-fabric restore ordering fixture: restore slots come from an
    allocate() whose failure path frees them, and each slot is committed
    copy-in (restore_block) FIRST, register AFTER — a half-written block
    must never become discoverable. The acquire outside any try (bad) is
    exactly the shape RTL404 exists for: a raise inside the copy-in loop
    skips the free and leaks every slot in the plan."""
    findings = lint(
        """
        class Engine:
            def bad(self, plan):
                tail = self.allocator.allocate(len(plan))
                for block, h in zip(tail, plan):
                    self.runner.restore_block(block, self.fabric.get(h))
                    self.allocator.register(block, h)
                self.allocator.free(tail)

            def good(self, plan):
                tail = self.allocator.allocate(len(plan))
                try:
                    for block, h in zip(tail, plan):
                        self.runner.restore_block(block, self.fabric.get(h))
                        self.allocator.register(block, h)
                except Exception:
                    self.allocator.free(tail)
                    raise
        """
    )
    rtl404 = [f for f in findings if f.rule == "RTL404"]
    assert len(rtl404) == 1 and rtl404[0].context.endswith("bad")


def test_suppression_with_reason_suppresses():
    findings = lint(
        """
        def fire(handle):
            # ray-tpu: lint-ignore[RTL401] metrics push is fire-and-forget
            handle.ping.remote()
        """
    )
    assert findings == []


def test_suppression_inline_and_wildcard():
    findings = lint(
        """
        def fire(handle):
            handle.ping.remote()  # ray-tpu: lint-ignore[*] intentional
        """
    )
    assert findings == []


def test_suppression_without_reason_is_reported_not_honored():
    findings = lint(
        """
        def fire(handle):
            # ray-tpu: lint-ignore[RTL401]
            handle.ping.remote()
        """
    )
    assert sorted(rules_of(findings)) == ["RTL002", "RTL401"]


def test_suppression_for_other_rule_does_not_mask():
    findings = lint(
        """
        def fire(handle):
            # ray-tpu: lint-ignore[RTL999] wrong id on purpose
            handle.ping.remote()
        """
    )
    assert "RTL401" in rules_of(findings)


def test_stacked_standalone_suppressions_both_honored():
    """Regression: two standalone lint-ignore comments above one statement
    both resolve to that statement's line; the second used to overwrite
    the first so neither finding stayed suppressed."""
    findings = lint(
        """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0

            def bump(self):
                with self._lock:
                    self._n += 1

            def fire(self, handle):
                # ray-tpu: lint-ignore[RTL201] snapshot read is fine here
                # ray-tpu: lint-ignore[RTL401] fire-and-forget by design
                handle.ping.remote(self._n)
        """
    )
    assert findings == []


def test_skip_dirs_only_apply_below_scan_root(tmp_path):
    """Regression: a checkout under a hidden/`build` ancestor used to be
    skipped entirely, making the gate vacuously clean on 0 files."""
    root = tmp_path / ".cache" / "build" / "proj"
    pkg = root / "pkg"
    pkg.mkdir(parents=True)
    (pkg / "mod.py").write_text("def fire(h):\n    h.ping.remote()\n")
    (pkg / "__pycache__").mkdir()
    (pkg / "__pycache__" / "mod.py").write_text("def fire(h):\n    h.ping.remote()\n")
    (root / "pyproject.toml").write_text("[project]\nname='x'\n")

    result = lint_paths([pkg], root=root)
    assert result.files_scanned == 1  # __pycache__ below the root still skipped
    assert rules_of(result.findings) == ["RTL401"]


def test_suppression_covers_multiline_statement():
    """Regression: a finding anchored to a continuation line of a
    black-wrapped statement escaped the ignore comment above it (the
    suppression mapped only to the statement's first line)."""
    findings = lint(
        """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._x = 0

            def bump(self):
                with self._lock:
                    self._x += 1

            def peek(self):
                # ray-tpu: lint-ignore[RTL201] racy snapshot is fine here
                return (
                    self._x
                    + 1
                )

            def also_bad(self):
                return self._x
        """
    )
    # The wrapped read is suppressed; the ignore must NOT leak past its
    # statement to `also_bad`.
    assert rules_of(findings) == ["RTL201"]
    assert findings[0].context.endswith("also_bad")


def test_suppression_on_compound_header_does_not_blanket_block():
    findings = lint(
        """
        def fire(h, cond):
            # ray-tpu: lint-ignore[RTL401] header-anchored, body must flag
            if cond(
                h
            ):
                h.ping.remote()
        """
    )
    # The body finding is NOT suppressed — and the header-anchored ignore
    # therefore protects nothing, which RTL003 reports as rot.
    assert rules_of(findings) == ["RTL003", "RTL401"]


def test_scoped_run_does_not_report_out_of_scope_baseline_stale(tmp_path):
    """Regression: a path- or rule-scoped run used to report every
    baseline entry it could not have re-produced as stale, telling users
    to regenerate (and dashboards that the baseline rotted)."""
    pkg = _write_pkg(tmp_path)  # mod.py: RTL302 + RTL401
    full = lint_paths([pkg], root=tmp_path)
    baseline = {
        f.fingerprint: baseline_mod.entry_for(f, "triaged: fixture")
        for f in full.findings
    }

    by_rule = lint_paths(
        [pkg], rule_ids=["RTL302"], root=tmp_path, baseline=baseline
    )
    assert by_rule.stale_baseline == []

    other = tmp_path / "other"
    other.mkdir()
    (other / "clean.py").write_text("x = 1\n")
    by_path = lint_paths([other], root=tmp_path, baseline=baseline)
    assert by_path.stale_baseline == []

    # A genuinely-fixed finding in scope still reports stale.
    (pkg / "mod.py").write_text("x = 1\n")
    fixed = lint_paths([pkg], root=tmp_path, baseline=baseline)
    assert len(fixed.stale_baseline) == 2


def test_baseline_round_trip(tmp_path):
    src = textwrap.dedent(
        """
        def fire(handle):
            handle.ping.remote()
        """
    )
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text(src)
    (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")

    result = lint_paths([pkg], root=tmp_path)
    assert rules_of(result.findings) == ["RTL401"]

    # Baseline it with a reason -> clean; entry survives line drift.
    bl = tmp_path / baseline_mod.BASELINE_FILENAME
    baseline_mod.save_baseline(
        bl, [baseline_mod.entry_for(result.findings[0], "known fire-forget")]
    )
    baseline = baseline_mod.load_baseline(bl)
    again = lint_paths([pkg], root=tmp_path, baseline=baseline)
    assert again.findings == [] and len(again.baselined) == 1

    (pkg / "mod.py").write_text("# a new comment line\n" + src)
    drifted = lint_paths([pkg], root=tmp_path, baseline=baseline)
    assert drifted.findings == [] and len(drifted.baselined) == 1

    # Fixing the finding leaves a stale entry, reported as such.
    (pkg / "mod.py").write_text("def fire(h):\n    return h.ping.remote()\n")
    fixed = lint_paths([pkg], root=tmp_path, baseline=baseline)
    assert fixed.findings == [] and fixed.stale_baseline


def _write_pkg(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text(
        "import time\n\n"
        "def t(fn):\n"
        "    t0 = time.time()\n"
        "    fn()\n"
        "    return time.time() - t0\n\n"
        "def fire(h):\n"
        "    h.ping.remote()\n"
    )
    (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")
    return pkg


def test_cli_json_shape(tmp_path, capsys, monkeypatch):
    pkg = _write_pkg(tmp_path)
    monkeypatch.chdir(tmp_path)
    rc = lint_main([str(pkg), "--json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1
    # Schema version 3: the diff-scoped scan added files_checked (new
    # keys never appear under an old version number, so external
    # consumers can gate on report shape).
    assert report["version"] == 3
    assert report["schema"] == "ray-tpu-lint-report/3"
    assert report["files_scanned"] == 1
    assert report["files_checked"] == 1
    assert set(report["counts"]) == {
        "active", "baselined", "suppressed", "parse_errors",
        "stale_baseline", "untriaged_baseline",
    }
    assert report["counts"]["active"] == len(report["findings"]) == 2
    finding = report["findings"][0]
    assert set(finding) == {
        "rule", "name", "family", "path", "line", "col", "context",
        "message", "fingerprint",
    }
    assert {f["rule"] for f in report["findings"]} == {"RTL302", "RTL401"}


def test_cli_rule_filter_and_exit_codes(tmp_path, capsys, monkeypatch):
    pkg = _write_pkg(tmp_path)
    monkeypatch.chdir(tmp_path)
    rc = lint_main([str(pkg), "--rule", "RTL401", "--json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert {f["rule"] for f in report["findings"]} == {"RTL401"}
    # Filtering to a rule with no findings -> exit 0.
    assert lint_main([str(pkg), "--rule", "RTL102"]) == 0
    capsys.readouterr()
    assert lint_main([str(tmp_path / "nope")]) == 2


def test_cli_write_baseline_then_clean(tmp_path, capsys, monkeypatch):
    pkg = _write_pkg(tmp_path)
    monkeypatch.chdir(tmp_path)
    assert lint_main([str(pkg), "--write-baseline"]) == 0
    capsys.readouterr()
    bl_path = tmp_path / baseline_mod.BASELINE_FILENAME
    data = json.loads(bl_path.read_text())
    assert len(data["findings"]) == 2
    # TODO reasons gate: still exit 1 until a human writes reasons.
    assert lint_main([str(pkg)]) == 1
    capsys.readouterr()
    for e in data["findings"]:
        e["reason"] = "triaged: intentional in this fixture"
    bl_path.write_text(json.dumps(data))
    assert lint_main([str(pkg)]) == 0


def test_overlapping_scan_paths_deduplicated(tmp_path):
    """Regression: `lint pkg pkg/sub` used to scan sub's files twice —
    the duplicate findings got occurrence-shifted fingerprints that no
    longer matched the baseline, resurfacing grandfathered entries."""
    pkg = _write_pkg(tmp_path)
    result = lint_paths(
        [tmp_path, pkg, pkg / "mod.py"], root=tmp_path
    )
    assert result.files_scanned == 1
    assert len(result.findings) == 2

    bl = [
        baseline_mod.entry_for(f, "triaged: fixture")
        for f in result.findings
    ]
    baseline = {e["fingerprint"]: e for e in bl}
    again = lint_paths([tmp_path, pkg], root=tmp_path, baseline=baseline)
    assert again.findings == [] and len(again.baselined) == 2


def test_cli_lint_reachable_through_argparse_dispatch(capsys):
    """Regression: `ray-tpu-torch --num-cpus 2 lint ...` bypasses the argv[0]
    fast-path intercept and used to die with KeyError('lint') in the
    handler dict."""
    from ray_tpu_torch.scripts.cli import main as ray_tpu_main

    rc = ray_tpu_main(
        ["--num-cpus", "2", "lint", "--", "--list-rules"]
    )
    out = capsys.readouterr().out
    assert rc == 0
    assert "RTL201" in out
    # And the fast path still owns bare `lint` flags.
    assert ray_tpu_main(["lint", "--list-rules"]) == 0


def test_write_baseline_scoped_run_preserves_out_of_scope(
    tmp_path, capsys, monkeypatch
):
    """Regression: a --write-baseline scoped by path or --rule used to
    treat every entry outside the scan as stale, deleting triaged
    reasons; re-running also used to re-stamp written reasons with TODO."""
    pkg_a = _write_pkg(tmp_path)  # RTL302 + RTL401
    pkg_b = tmp_path / "other"
    pkg_b.mkdir()
    (pkg_b / "mod.py").write_text("def fire(h):\n    h.ping.remote()\n")
    monkeypatch.chdir(tmp_path)
    bl_path = tmp_path / baseline_mod.BASELINE_FILENAME

    assert lint_main([str(pkg_a), str(pkg_b), "--write-baseline"]) == 0
    capsys.readouterr()
    data = json.loads(bl_path.read_text())
    assert len(data["findings"]) == 3
    for e in data["findings"]:
        e["reason"] = "triaged: intentional in this fixture"
    bl_path.write_text(json.dumps(data))

    # Path-scoped rewrite: pkg_b's entry and every written reason survive.
    assert lint_main([str(pkg_a), "--write-baseline"]) == 0
    out = capsys.readouterr().out
    assert "0 new" in out
    data = json.loads(bl_path.read_text())
    assert len(data["findings"]) == 3
    assert all(e["reason"].startswith("triaged") for e in data["findings"])

    # Rule-scoped rewrite after fixing that rule's finding: only the
    # in-scope stale entry drops.
    (pkg_a / "mod.py").write_text(
        "import time\n\ndef t(fn):\n    t0 = time.time()\n    fn()\n"
        "    return time.time() - t0\n"
    )
    assert lint_main(
        [str(pkg_a), str(pkg_b), "--rule", "RTL401", "--write-baseline"]
    ) == 0
    capsys.readouterr()
    data = json.loads(bl_path.read_text())
    assert {e["rule"] for e in data["findings"]} == {"RTL302", "RTL401"}
    assert len(data["findings"]) == 2  # pkg_a RTL401 dropped, RTL302 kept
    assert lint_main([str(pkg_a), str(pkg_b)]) == 0


def test_unused_suppression_flagged_only_on_full_runs():
    """An orphaned reasoned lint-ignore (hazard fixed, or comment drifted
    off the statement) is rot: RTL003 on full runs. A rule-scoped run
    must stay silent — the other rules never had a chance to match it —
    and a docstring SHOWING the idiom is string content, not a comment."""
    src = """
        def fire(h):
            # ray-tpu: lint-ignore[RTL401] nothing below fires this rule
            return h.value
        """
    assert rules_of(lint(src)) == ["RTL003"]

    from ray_tpu_torch.tools.lint.rules_resources import DroppedObjectRefRule

    assert lint(src, rules=[DroppedObjectRefRule()]) == []

    used = lint(
        """
        def fire(h):
            # ray-tpu: lint-ignore[RTL401] fire-and-forget by design
            h.ping.remote()
        """
    )
    assert used == []

    doc = lint(
        '''
        def helper():
            """Suppress false positives like this:

                x()  # ray-tpu: lint-ignore[RTL201] probe reads stale bool
            """
            return 1
        '''
    )
    assert doc == []


def test_cli_json_parse_errors_not_mixed_into_findings(
    tmp_path, capsys, monkeypatch
):
    """Regression: --json used to append RTL001 parse errors into the
    `findings` array while counts.active excluded them, so a consumer
    gating on counts.active == 0 rendered 'clean' beside a non-empty
    findings list."""
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "broken.py").write_text("def broken(:\n")
    (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")
    monkeypatch.chdir(tmp_path)
    rc = lint_main([str(pkg), "--json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert report["counts"]["active"] == len(report["findings"]) == 0
    assert report["counts"]["parse_errors"] == 1
    assert [e["rule"] for e in report["parse_errors"]] == ["RTL001"]


def test_write_baseline_preserves_entries_of_unparseable_file(
    tmp_path, capsys, monkeypatch
):
    """Regression: --write-baseline used to drop the triaged entries (and
    their written reasons) of any file with a transient syntax error —
    the file produced no findings, so its entries looked stale. Once the
    file parsed again its findings came back active and broke the gate."""
    pkg = _write_pkg(tmp_path)  # mod.py: RTL302 + RTL401
    monkeypatch.chdir(tmp_path)
    bl_path = tmp_path / baseline_mod.BASELINE_FILENAME

    assert lint_main([str(pkg), "--write-baseline"]) == 0
    capsys.readouterr()
    data = json.loads(bl_path.read_text())
    assert len(data["findings"]) == 2
    for e in data["findings"]:
        e["reason"] = "triaged: intentional in this fixture"
    bl_path.write_text(json.dumps(data))

    good_source = (pkg / "mod.py").read_text()
    (pkg / "mod.py").write_text(good_source + "def broken(:\n")
    assert lint_main([str(pkg), "--write-baseline"]) == 0
    capsys.readouterr()
    data = json.loads(bl_path.read_text())
    assert len(data["findings"]) == 2
    assert all(e["reason"].startswith("triaged") for e in data["findings"])

    (pkg / "mod.py").write_text(good_source)
    assert lint_main([str(pkg)]) == 0


def test_same_actor_blocking_get_via_partial_bound_remote():
    """functools.partial-bound remote methods resolve to the underlying
    handle (the satellite cross-module shape)."""
    findings = lint(
        """
        import functools
        import ray_tpu_torch

        @ray_tpu_torch.remote
        class Coord:
            def __init__(self):
                self._peer = Coord.remote()

            def helper(self, x):
                return x

            def run(self, x):
                fire = functools.partial(self._peer.helper.remote, x)
                ref = fire()
                return ray_tpu_torch.get(ref)
        """
    )
    assert "RTL701" in rules_of(findings)


def test_cross_actor_cycle_with_aliased_import():
    """A -> B -> A across modules, with B's class imported under another
    name (actor-class-aliased-at-import satellite)."""
    findings = lint_files(
        {
            "pkg/beta.py": """
                import ray_tpu_torch
                from pkg import alpha

                @ray_tpu_torch.remote
                class Beta:
                    def __init__(self):
                        self._a = alpha.Alpha.remote()

                    def pong(self, x):
                        return ray_tpu_torch.get(self._a.poke.remote(x))
            """,
            "pkg/alpha.py": """
                import ray_tpu_torch

                @ray_tpu_torch.remote
                class Alpha:
                    def __init__(self):
                        from pkg.beta import Beta as Remote_B
                        self._b = Remote_B.remote()

                    def ping(self, x):
                        return ray_tpu_torch.get(self._b.pong.remote(x))

                    def poke(self, x):
                        return x
            """,
        }
    )
    assert rules_of(findings).count("RTL702") == 2

    # One-way dependency: no cycle, no finding.
    findings = lint_files(
        {
            "pkg/beta.py": """
                import ray_tpu_torch

                @ray_tpu_torch.remote
                class Beta:
                    def pong(self, x):
                        return x + 1
            """,
            "pkg/alpha.py": """
                import ray_tpu_torch
                from pkg.beta import Beta

                @ray_tpu_torch.remote
                class Alpha:
                    def __init__(self):
                        self._b = Beta.remote()

                    def ping(self, x):
                        return ray_tpu_torch.get(self._b.pong.remote(x))
            """,
        }
    )
    assert "RTL702" not in rules_of(findings)


def test_registered_handle_name_resolves_cross_module():
    """`RemoteX = ray_tpu_torch.remote(X)` registrations resolve from another
    module (the rllib RemoteEnvRunner shape)."""
    findings = lint_files(
        {
            "pkg/worker.py": """
                import ray_tpu_torch

                class Worker:
                    def work(self, x):
                        return x

                RemoteWorker = ray_tpu_torch.remote(Worker)
            """,
            "pkg/driver.py": """
                import ray_tpu_torch
                from pkg.worker import RemoteWorker

                @ray_tpu_torch.remote
                class Driver:
                    def __init__(self):
                        self._w = RemoteWorker.options(num_cpus=0).remote()

                    def run(self, x):
                        return ray_tpu_torch.get(self._w.work.remote(x))
            """,
        }
    )
    # One-way blocking call: NOT a deadlock — no findings, but the edge
    # resolving at all is what this test pins (a cycle through the same
    # registration shape must then be detectable).
    assert "RTL702" not in rules_of(findings)
    assert "RTL701" not in rules_of(findings)


def test_changed_only_scopes_rules_to_reverse_import_closure(tmp_path):
    """lint_paths(changed_only=...) parses everything but runs rules
    only on the changed files plus their importers: an unchanged,
    unrelated module's finding must NOT appear; an importer of the
    changed module IS re-checked."""
    (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "base.py").write_text("VALUE = 3\n")
    (pkg / "uses.py").write_text(
        "import time\n\nfrom pkg.base import VALUE\n\n\n"
        "def wait(t):\n"
        "    deadline = time.time() + t\n"
        "    while time.time() < deadline:\n"
        "        pass\n"
    )
    (pkg / "unrelated.py").write_text(
        "def fire(h):\n    h.ping.remote()\n"
    )
    result = lint_paths(
        [pkg], root=tmp_path, changed_only=["pkg/base.py"]
    )
    # Closure: base.py itself + its importer uses.py — not unrelated.py.
    assert result.checked_relpaths == {"pkg/base.py", "pkg/uses.py"}
    assert {f.rule for f in result.findings} == {"RTL302"}
    assert result.files_scanned == 4  # everything still parsed

    # An empty diff checks nothing and is clean.
    result = lint_paths([pkg], root=tmp_path, changed_only=[])
    assert result.checked_relpaths == set()
    assert result.findings == []


def test_changed_cli_flag_against_real_git(tmp_path, capsys, monkeypatch):
    """End to end: `ray-tpu-torch lint --changed` diffs against git HEAD —
    a committed-clean tree reports nothing; touching one file (and
    adding an untracked one) scopes the scan to the diff closure."""
    import shutil
    import subprocess

    if shutil.which("git") is None:
        pytest.skip("git not available")

    def git(*argv):
        subprocess.run(
            ["git", "-C", str(tmp_path), "-c", "user.email=t@t",
             "-c", "user.name=t", *argv],
            check=True, capture_output=True,
        )

    (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "mod.py").write_text("VALUE = 3\n")
    git("init", "-q")
    git("add", "-A")
    git("commit", "-qm", "seed")
    monkeypatch.chdir(tmp_path)

    assert lint_main([str(pkg), "--changed", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["files_checked"] == 0
    assert report["files_scanned"] == 2

    # Tracked modification + an untracked file both land in the diff.
    (pkg / "mod.py").write_text(
        "import time\n\n\ndef wait(t):\n"
        "    deadline = time.time() + t\n"
        "    while time.time() < deadline:\n"
        "        pass\n"
    )
    (pkg / "fresh.py").write_text(
        "def fire(h):\n    h.ping.remote()\n"
    )
    rc = lint_main([str(pkg), "--changed", "--json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert report["files_checked"] == 2
    assert {f["rule"] for f in report["findings"]} == {
        "RTL302", "RTL401",
    }
    # Outside a work tree (git errors) the flag is a usage error, not
    # a crash — simulated, since tmp_path itself IS a work tree here.
    from ray_tpu_torch.tools.lint import cli as cli_mod

    monkeypatch.setattr(
        cli_mod, "_git_changed_files", lambda root: None
    )
    assert lint_main([str(pkg), "--changed"]) == 2
    capsys.readouterr()


def test_changed_relativizes_to_lint_root_in_monorepo(
    tmp_path, capsys, monkeypatch
):
    """Regression: the lint root (pyproject.toml) can be a SUBDIRECTORY
    of the git toplevel. `git diff --name-only` prints toplevel-relative
    paths, which match no module relpath — without --relative a
    monorepo `lint --changed` silently checked zero files and exited 0
    over real findings."""
    import shutil
    import subprocess

    if shutil.which("git") is None:
        pytest.skip("git not available")

    def git(*argv):
        subprocess.run(
            ["git", "-C", str(tmp_path), "-c", "user.email=t@t",
             "-c", "user.name=t", *argv],
            check=True, capture_output=True,
        )

    sub = tmp_path / "service"
    pkg = sub / "pkg"
    pkg.mkdir(parents=True)
    (sub / "pyproject.toml").write_text("[project]\nname='x'\n")
    (pkg / "__init__.py").write_text("")
    (pkg / "mod.py").write_text("VALUE = 3\n")
    git("init", "-q")
    git("add", "-A")
    git("commit", "-qm", "seed")
    (pkg / "mod.py").write_text(
        "import time\n\n\ndef wait(t):\n"
        "    deadline = time.time() + t\n"
        "    while time.time() < deadline:\n"
        "        pass\n"
    )
    monkeypatch.chdir(sub)
    rc = lint_main([str(pkg), "--changed", "--json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert report["files_checked"] == 1
    assert {f["rule"] for f in report["findings"]} == {"RTL302"}


def test_changed_closure_includes_bare_dotted_importers(tmp_path):
    """`import pkg.base` (no `as`) must register a dependency on
    pkg/base.py, not just pkg/__init__.py, or the importer escapes the
    --changed closure. Same for `from pkg.base import *`, which binds
    no alias at all. And deleting a module entirely must still seed the
    closure with its former importers — a pure deletion re-checks
    everything that resolved symbols through the deleted file."""
    (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "base.py").write_text("VALUE = 3\n")
    (pkg / "uses.py").write_text(
        "import pkg.base\n\nX = pkg.base.VALUE\n"
    )
    (pkg / "star.py").write_text("from pkg.base import *\n")
    result = lint_paths(
        [pkg], root=tmp_path, changed_only=["pkg/base.py"]
    )
    assert "pkg/uses.py" in result.checked_relpaths
    assert "pkg/star.py" in result.checked_relpaths
    # Deleted module: the path has no ModuleInfo, but importers of its
    # module name (here via `import pkg.gone`) are still re-checked.
    (pkg / "needs_gone.py").write_text(
        "import pkg.gone\n\nY = pkg.gone.VALUE\n"
    )
    result = lint_paths(
        [pkg], root=tmp_path, changed_only=["pkg/gone.py"]
    )
    assert "pkg/needs_gone.py" in result.checked_relpaths


def test_write_baseline_changed_scope_preserves_unchecked_entries(
    tmp_path, capsys, monkeypatch
):
    """Regression: --write-baseline used to scope stale-dropping by
    scan PATHS, so a diff-scoped run (file parsed but not checked)
    would have treated every unchecked file's triaged entries as stale
    and deleted them. The write must scope to the CHECKED set — the
    files whose rules actually ran."""
    (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "a.py").write_text(
        "import time\n\n\ndef wait(t):\n"
        "    deadline = time.time() + t\n"
        "    while time.time() < deadline:\n"
        "        pass\n"
    )
    (pkg / "b.py").write_text("def fire(h):\n    h.ping.remote()\n")
    monkeypatch.chdir(tmp_path)
    bl_path = tmp_path / baseline_mod.BASELINE_FILENAME
    assert lint_main([str(pkg), "--write-baseline"]) == 0
    capsys.readouterr()
    data = json.loads(bl_path.read_text())
    assert len(data["findings"]) == 2
    for e in data["findings"]:
        e["reason"] = "triaged: fixture"
    bl_path.write_text(json.dumps(data))

    # Diff-scoped rewrite touching only a.py: b.py was parsed but NOT
    # checked — its triaged entry (and reason) must survive verbatim.
    from ray_tpu_torch.tools.lint import cli as cli_mod

    monkeypatch.setattr(
        cli_mod, "_git_changed_files", lambda root: {"pkg/a.py"}
    )
    assert lint_main([str(pkg), "--changed", "--write-baseline"]) == 0
    capsys.readouterr()
    data = json.loads(bl_path.read_text())
    assert {e["rule"] for e in data["findings"]} == {"RTL302", "RTL401"}
    assert all(
        e["reason"] == "triaged: fixture" for e in data["findings"]
    )
    # The checked file's entry DOES drop once its finding is fixed.
    (pkg / "a.py").write_text("VALUE = 3\n")
    assert lint_main([str(pkg), "--changed", "--write-baseline"]) == 0
    capsys.readouterr()
    data = json.loads(bl_path.read_text())
    assert {e["rule"] for e in data["findings"]} == {"RTL401"}
    assert lint_main([str(pkg)]) == 0
    capsys.readouterr()


def test_cli_sarif_shape(tmp_path, capsys, monkeypatch):
    pkg = _write_pkg(tmp_path)  # mod.py: RTL302 + RTL401
    monkeypatch.chdir(tmp_path)
    rc = lint_main([str(pkg), "--sarif"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert report["version"] == "2.1.0"
    assert report["$schema"].endswith("sarif-schema-2.1.0.json")
    run = report["runs"][0]
    driver = run["tool"]["driver"]
    assert driver["name"] == "ray-tpu-torch-lint"
    ids = {r["id"] for r in driver["rules"]}
    # The driver lists the port's registry: the carried rules and RTL804,
    # never a rule that is not ported.
    assert ids == {r.id for r in all_rules()}
    assert {"RTL201", "RTL701", "RTL804"} <= ids
    assert not ids & set(NOT_PORTED)
    results = run["results"]
    assert {r["ruleId"] for r in results} == {"RTL302", "RTL401"}
    for r in results:
        assert r["level"] == "warning"
        loc = r["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uri"].endswith("mod.py")
        assert loc["region"]["startLine"] >= 1
        assert r["partialFingerprints"]["rayTpuLint/v1"]
    # Clean tree -> empty results, exit 0.
    clean = tmp_path / "clean"
    clean.mkdir()
    (clean / "ok.py").write_text("x = 1\n")
    capsys.readouterr()
    assert lint_main([str(clean), "--sarif"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["runs"][0]["results"] == []


def test_cli_explain_prints_rationale_and_examples(capsys):
    assert lint_main(["--explain", "RTL804"]) == 0
    out = capsys.readouterr().out
    assert "paired-pool-geometry" in out
    assert "Why:" in out
    assert "Fires on:" in out and "Clean form:" in out
    # The pair is written in torch.
    assert "torch.zeros" in out and "jnp" not in out
    # By name works too; unknown rule is a usage error.
    assert lint_main(["--explain", "cross-actor-call-cycle"]) == 0
    capsys.readouterr()
    assert lint_main(["--explain", "RTL999"]) == 2


def test_actor_cycle_through_reachable_helper():
    """The actor-method reachability index: a blocking get inside a
    plain helper function REACHED from an actor method (through the
    project call graph, across modules) contributes that actor's edge —
    here closing an A→B→A cycle whose first leg lives in a helper."""
    findings = lint_files(
        {
            "pkg/helpers.py": """
                import ray_tpu_torch
                from pkg.beta import Beta

                def fetch_pong(x):
                    h = Beta.remote()
                    return ray_tpu_torch.get(h.pong.remote(x))
            """,
            "pkg/alpha.py": """
                import ray_tpu_torch
                from pkg.helpers import fetch_pong

                @ray_tpu_torch.remote
                class Alpha:
                    def ping(self, x):
                        return fetch_pong(x)

                    def poke(self, x):
                        return x
            """,
            "pkg/beta.py": """
                import ray_tpu_torch

                @ray_tpu_torch.remote
                class Beta:
                    def __init__(self):
                        from pkg.alpha import Alpha
                        self._a = Alpha.remote()

                    def pong(self, x):
                        return ray_tpu_torch.get(self._a.poke.remote(x))
            """,
        }
    )
    rtl702 = [f for f in findings if f.rule == "RTL702"]
    assert len(rtl702) == 2
    assert {f.path for f in rtl702} == {"pkg/helpers.py", "pkg/beta.py"}
    # The helper-side finding names the reaching method.
    helper_f = [f for f in rtl702 if f.path == "pkg/helpers.py"][0]
    assert "via fetch_pong" in helper_f.message


def test_function_local_registration_does_not_leak():
    """Review regression: a method-local `h = ray_tpu_torch.remote(Cls)` must
    not register module-wide, and an OPAQUE local binding of the same
    name elsewhere must not fall back to any registration."""
    findings = lint(
        """
        import ray_tpu_torch

        @ray_tpu_torch.remote
        class Driver:
            def spawn(self):
                h = ray_tpu_torch.remote(Driver)
                return h

            def poll(self):
                h = make_handle()  # opaque: class unknown
                return ray_tpu_torch.get(h.work.remote(1))

            def work(self, x):
                return x
        """
    )
    assert "RTL701" not in rules_of(findings)


# ---------------------------------------------------------------------------
# Parity with the reference analyzer, rule by rule
# ---------------------------------------------------------------------------

CARRIED = sorted(r.id for r in all_rules() if r.id != "RTL804")

# The reference's cases whose fixtures feed the parity check: the carried
# families, the suppressions and the meta rules.
PARITY_CASES = (
    "test_blocking_get_in_async_def_flagged",
    "test_blocking_calls_via_alias_and_result",
    "test_awaited_and_offloaded_calls_not_flagged",
    "test_nested_sync_def_inside_async_not_flagged",
    "test_threading_event_wait_in_async_def_flagged",
    "test_await_while_holding_threading_lock_flagged",
    "test_await_under_local_lock_and_async_gen",
    "test_unawaited_local_coroutine_flagged",
    "test_lock_coverage_flags_bare_access_only",
    "test_bare_attribute_expression_read_flagged",
    "test_condition_alias_counts_as_same_lock",
    "test_unguarded_attrs_and_init_not_flagged",
    "test_setup_style_lock_construction_exempt",
    "test_nested_callback_access_not_flagged",
    "test_manual_acquire_flagged",
    "test_wallclock_deadline_and_duration_flagged",
    "test_monotonic_deadline_arithmetic_pinned",
    "test_wallclock_identity_not_flagged",
    "test_dropped_object_ref_flagged_and_bound_ok",
    "test_cleared_before_commit_flagged_and_fixed_form_ok",
    "test_leaky_acquire_flagged_and_try_ok",
    "test_leaky_acquire_kv_fabric_restore_path_fixture",
    "test_suppression_with_reason_suppresses",
    "test_suppression_inline_and_wildcard",
    "test_suppression_without_reason_is_reported_not_honored",
    "test_suppression_for_other_rule_does_not_mask",
    "test_stacked_standalone_suppressions_both_honored",
    "test_suppression_covers_multiline_statement",
    "test_suppression_on_compound_header_does_not_blanket_block",
    "test_unused_suppression_flagged_only_on_full_runs",
    "test_same_actor_blocking_get_via_partial_bound_remote",
    "test_cross_actor_cycle_with_aliased_import",
    "test_registered_handle_name_resolves_cross_module",
    "test_actor_cycle_through_reachable_helper",
    "test_function_local_registration_does_not_leak",
)


def _literal(node, scopes):
    """A fixture argument: a string, or a {relpath: string} dict, given
    inline or through a name bound in the test or at module level."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Dict):
        return {k.value: _literal(v, scopes) for k, v in zip(node.keys, node.values)}
    if isinstance(node, ast.Name):
        for scope in scopes:
            for stmt in ast.walk(scope):
                if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == node.id for t in stmt.targets
                ):
                    return _literal(stmt.value, scopes)
    raise AssertionError(f"unreadable fixture {ast.dump(node)[:80]}")


def reference_fixtures():
    """Every fixture the PARITY_CASES hand to `lint` / `lint_files` in
    tests/test_lint.py, as {relpath: source} (a single source under
    snippet.py), plus the carried rules' --explain examples."""
    from ray_tpu.tools.lint import all_rules as ref_rules

    tree = ast.parse((REPO_ROOT / "tests" / "test_lint.py").read_text())
    tests = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    out = []
    for name in PARITY_CASES:
        fn = tests[name]
        for call in ast.walk(fn):
            if isinstance(call, ast.Call) and isinstance(call.func, ast.Name) \
                    and call.func.id in ("lint", "lint_files") and call.args:
                value = _literal(call.args[0], [fn, tree])
                files = value if isinstance(value, dict) else {"snippet.py": value}
                out.append((name, {p: textwrap.dedent(s) for p, s in files.items()}))
    for rule in ref_rules():
        if rule.id in CARRIED:
            for kind in ("bad_example", "good_example"):
                out.append((f"{rule.id}.{kind}",
                            {"snippet.py": textwrap.dedent(getattr(rule, kind))}))
    return out


def _scan(lint_paths_fn, root: Path, files: dict, rule_id: str):
    for relpath, source in files.items():
        path = root / relpath
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(source)
    # RTL003 is produced only when the whole registry ran.
    rule_ids = None if rule_id == "RTL003" else [rule_id]
    result = lint_paths_fn([root], rule_ids=rule_ids, root=root)
    return [f for f in result.findings + [x for x, _ in result.suppressed]
            if f.rule == rule_id]


def test_parity_fixtures_were_read():
    fixtures = reference_fixtures()
    assert len({name for name, _ in fixtures}) == len(PARITY_CASES) + 2 * len(CARRIED)
    assert len(fixtures) > 50


@pytest.mark.parametrize("rule_id", CARRIED + ["RTL002", "RTL003"])
def test_carried_rule_matches_the_reference(rule_id, tmp_path):
    """Both analyzers on the same fixtures (the port's copy renamed) give
    the same findings, fingerprints included: the port hashes a finding
    on its own text exactly as the reference hashes it on the same text,
    and on a line without `ray_tpu` the two fingerprints are equal."""
    from ray_tpu.tools.lint import lint_paths as ref_lint_paths
    from ray_tpu.tools.lint.core import _fingerprint as ref_fingerprint

    fired = 0
    for i, (name, files) in enumerate(reference_fixtures()):
        ref = _scan(ref_lint_paths, tmp_path / f"ref{i}", files, rule_id)
        port_files = {p: to_port(s) for p, s in files.items()}
        port = _scan(lint_paths, tmp_path / f"port{i}", port_files, rule_id)
        fired += len(ref)

        def key(f, message):
            return (f.rule, f.path, f.line, f.col, f.context, message)

        assert [key(f, f.message) for f in ref] == [
            key(f, f.message.replace("ray_tpu_torch", "ray_tpu")) for f in port
        ], name
        seen = {}
        for f in port:
            text = port_files[f.path].splitlines()[f.line - 1]
            base = (f.rule, f.path, f.context, "".join(text.split()))
            occ = seen.get(base, 0)
            seen[base] = occ + 1
            assert f.fingerprint == ref_fingerprint(
                f.rule, f.path, f.context, text, occ
            ), name
        for a, b in zip(ref, port):
            if "ray_tpu" not in files[a.path].splitlines()[a.line - 1]:
                assert a.fingerprint == b.fingerprint, name
    # Every rule fires somewhere in its family's fixtures.
    assert fired > 0, rule_id


# ---------------------------------------------------------------------------
# The registry: carried + not ported == the reference's
# ---------------------------------------------------------------------------


def test_registry_plus_not_ported_is_the_reference_registry():
    from ray_tpu.tools.lint import all_rules as ref_rules

    ref = {r.id: r for r in ref_rules()}
    port = {r.id: r for r in all_rules()}
    assert not set(port) & set(NOT_PORTED)
    assert set(port) | set(NOT_PORTED) == set(ref)
    for rid, rule in port.items():
        assert (rule.name, rule.family) == (ref[rid].name, ref[rid].family), rid
    for rid, (name, reason) in NOT_PORTED.items():
        assert name == ref[rid].name, rid
        assert len(reason) > 30, rid


def test_list_rules_prints_every_dropped_rule_with_its_reason(capsys):
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    carried, _, dropped = out.partition("not ported")
    for rule in all_rules():
        assert rule.id in carried
    for rid, (name, reason) in NOT_PORTED.items():
        assert rid not in carried
        assert f"{rid}  {name}" in dropped and reason in dropped


@pytest.mark.parametrize("rule_id", sorted(NOT_PORTED))
def test_dropped_rule_is_refused_by_rule_and_explain(rule_id, capsys, tmp_path):
    name, reason = NOT_PORTED[rule_id]
    for ident in (rule_id, name):
        assert lint_main(["--explain", ident]) == 2
        err = capsys.readouterr().err
        assert rule_id in err and "not ported" in err and reason in err
    assert lint_main([str(tmp_path), "--rule", rule_id]) == 2
    assert reason in capsys.readouterr().err


@pytest.mark.parametrize("rule", all_rules(), ids=lambda r: r.id)
def test_rule_example_pair_fires_and_stays_clean(rule):
    assert rule.rationale, f"{rule.id} has no rationale for --explain"
    assert rule.bad_example and rule.good_example
    bad = rules_of(lint(rule.bad_example))
    good = rules_of(lint(rule.good_example))
    assert rule.id in bad, f"{rule.id} does not fire on its own bad example"
    assert rule.id not in good, f"{rule.id} fires on its own good example"
    assert "jax" not in rule.bad_example + rule.good_example


def test_json_report_keeps_the_reference_schema(tmp_path, capsys, monkeypatch):
    from ray_tpu.tools.lint.cli import main as ref_main

    pkg = _write_pkg(tmp_path)
    monkeypatch.chdir(tmp_path)
    reports = []
    for main in (ref_main, lint_main):
        assert main([str(pkg), "--json", "--no-baseline"]) == 1
        reports.append(json.loads(capsys.readouterr().out))
    ref, port = reports
    assert set(ref) == set(port) and port["version"] == 3
    assert port["schema"] == ref["schema"]
    assert set(ref["counts"]) == set(port["counts"])
    assert [(f["rule"], f["line"], f["fingerprint"]) for f in ref["findings"]] == [
        (f["rule"], f["line"], f["fingerprint"]) for f in port["findings"]
    ]


# ---------------------------------------------------------------------------
# The project model on both trees
# ---------------------------------------------------------------------------


def _actor_index(core, project, tree: str):
    # The port's scan set for both analyzers: the reference's own would
    # also read a tree unpacked under a git-ignored `_build` directory.
    from ray_tpu_torch.tools.lint.core import iter_python_files

    modules = [
        core.ModuleInfo(f, f.resolve().relative_to(REPO_ROOT).as_posix(), f.read_text())
        for f in iter_python_files([REPO_ROOT / tree])
    ]
    index = project.ProjectInfo(modules).actor_index()
    return sorted(index.classes), sorted(index.registered.items())


def test_actor_index_matches_the_reference():
    """The port's index on ray_tpu_torch/ resolves the classes and
    registrations the reference's resolves on ray_tpu/: 9 and 3, the same
    qualnames after the prefix swap. The reference's index sees none of
    the port's (its remote targets are its own package's)."""
    from ray_tpu.tools.lint import core as ref_core
    from ray_tpu.tools.lint import project as ref_project
    from ray_tpu_torch.tools.lint import core, project

    ref_classes, ref_registered = _actor_index(ref_core, ref_project, "ray_tpu")
    classes, registered = _actor_index(core, project, "ray_tpu_torch")
    assert (len(classes), len(registered)) == (9, 3)
    swap = lambda key: (key[0].replace("ray_tpu/", "ray_tpu_torch/", 1), key[1])
    assert classes == [swap(k) for k in ref_classes]
    assert registered == [(swap(k), swap(v)) for k, v in ref_registered]
    assert _actor_index(ref_core, ref_project, "ray_tpu_torch") == ([], [])


# ---------------------------------------------------------------------------
# The port's hand-off lock is a lock
# ---------------------------------------------------------------------------

HANDOFF_SERVER = """
    import threading

    from ray_tpu_torch.llm.engine import _HandoffLock


    class Server:
        def __init__(self):
            self._lock = _HandoffLock()
            self._work = threading.Condition(self._lock)
            self._requests = {}

        def submit(self, rid):
            with self._lock:
                self._requests[rid] = 1

        def loop(self):
            with self._work:
                self._requests.clear()

        def under_lock(self, rid):
            with self._lock:
                return self._requests.get(rid)

        def bare(self, rid):
            return self._requests.get(rid)
"""


def test_handoff_lock_guards_like_a_threading_lock():
    findings = lint(HANDOFF_SERVER)
    assert rules_of(findings) == ["RTL201"]
    assert findings[0].context == "Server.bare"
    # The reference analyzer knows only threading's locks: to it the same
    # class holds nothing under `with self._lock:`, so the read under the
    # lock is reported as a race (the port's LLMServer had four of them).
    from ray_tpu.tools.lint import lint_source as ref_lint_source

    ref = ref_lint_source(textwrap.dedent(HANDOFF_SERVER).replace(
        "ray_tpu_torch.llm.engine", "ray_tpu.llm.engine"))
    assert {f.context for f in ref if f.rule == "RTL201"} >= {
        "Server.under_lock", "Server.bare"
    }


def test_handoff_lock_resolves_where_it_is_defined_and_through_aliases():
    defining = textwrap.dedent("""
        import threading


        class _HandoffLock:
            def acquire(self):
                return True

            def release(self):
                pass


        class Server:
            def __init__(self):
                self._lock = _HandoffLock()
                self._n = 0

            def bump(self):
                with self._lock:
                    self._n += 1

            def peek(self):
                return self._n
    """)
    # In the module that defines it, resolved through the project model.
    findings = lint_sources({"ray_tpu_torch/llm/engine.py": defining})
    assert [(f.rule, f.context) for f in findings] == [("RTL201", "Server.peek")]
    # The same class elsewhere is not the port's lock: nothing is guarded.
    assert lint_sources({"other/engine.py": defining}) == []
    # Through an alias chain and a package re-export.
    user = textwrap.dedent("""
        from ray_tpu_torch.llm import Handoff as L


        class Box:
            def __init__(self):
                self._lock = L()
                self._n = 0

            def bump(self):
                with self._lock:
                    self._n += 1

            def peek(self):
                return self._n
    """)
    findings = lint_sources({
        "ray_tpu_torch/llm/engine.py": defining,
        "ray_tpu_torch/llm/__init__.py":
            "from ray_tpu_torch.llm.engine import _HandoffLock as Handoff\n",
        "app.py": user,
    })
    assert [(f.path, f.context) for f in findings if f.rule == "RTL201"] == [
        ("app.py", "Box.peek"), ("ray_tpu_torch/llm/engine.py", "Server.peek"),
    ]


def test_llm_server_lock_and_condition_are_one_lock():
    from ray_tpu_torch.tools.lint.core import ModuleInfo
    from ray_tpu_torch.tools.lint.project import ProjectInfo
    from ray_tpu_torch.tools.lint.rules_locks import class_lock_attrs

    rel = "ray_tpu_torch/llm/engine.py"
    module = ModuleInfo(REPO_ROOT / rel, rel, (REPO_ROOT / rel).read_text())
    ProjectInfo([module])
    server = next(c for c in module.nodes(ast.ClassDef) if c.name == "LLMServer")
    assert class_lock_attrs(module, server) == {"_lock": "_lock", "_work": "_lock"}


# ---------------------------------------------------------------------------
# RTL804 on torch pools
# ---------------------------------------------------------------------------


def test_paired_pool_scale_dtype_and_write_coverage():
    """RTL804's forms on torch: an int scale pool fires; a pool write with
    no paired scale write fires (copy_, index_put_, item assignment); a
    None-guarded scale write is the sanctioned pattern and stays clean."""
    bad_dtype = """
        import torch

        def build(n, bs, h, d):
            k_cache = torch.zeros((2, n, bs, h, d), dtype=torch.int8)
            k_scale = torch.zeros((2, n, bs, h), dtype=torch.int32)
            return k_cache, k_scale
    """
    assert "RTL804" in rules_of(lint(bad_dtype))
    for write in ("k_cache[:, dst] = k_cache[:, src]",
                  "k_cache[:, dst].copy_(k_cache[:, src])",
                  "k_cache.index_copy_(1, dst, k_cache[:, src])",
                  "k_cache[0].index_put_((dst,), k_cache[0, src])"):
        bad_copy = f"""
            def copy_block(k_cache, k_scale, src, dst):
                {write}
        """
        found = [f for f in lint(bad_copy) if f.rule == "RTL804"]
        assert len(found) == 1 and "never updated" in found[0].message, write
    guarded = """
        def copy_block(k_cache, k_scale, src, dst):
            k_cache[:, dst] = k_cache[:, src]
            if k_scale is not None:
                k_scale[:, dst] = k_scale[:, src]
    """
    assert "RTL804" not in rules_of(lint(guarded))


def test_paired_pool_class_attributes_and_lambda_constructor():
    """The runner's shape: pools built in __init__ through a bound lambda
    as self attributes, written by another method."""
    src = """
        import torch

        class Runner:
            def __init__(self, cfg, n, bs):
                shape = (cfg.layers, n, bs, cfg.heads, cfg.dim)
                zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype)
                self.k_cache = zeros(shape, torch.int8)
                self.k_scale = zeros(shape[{cut}], torch.bfloat16)

            def scatter(self, idx, k, ks):
                self.k_cache.index_put_(idx, k)
                {scale_write}
    """
    ok = src.format(cut=":-1", scale_write="self.k_scale.index_put_(idx, ks)")
    assert "RTL804" not in rules_of(lint(ok))
    rank = src.format(cut=":3", scale_write="self.k_scale.index_put_(idx, ks)")
    assert [f.line for f in lint(rank) if f.rule == "RTL804"] == [9]
    skipped = src.format(cut=":-1", scale_write="pass")
    assert [f.line for f in lint(skipped) if f.rule == "RTL804"] == [12]


def test_paired_pool_unknown_geometry_stays_silent():
    """TOP cases: pools built by an opaque helper, a branch that binds the
    shape two ways, a constructor given `*shape`, and a scale pool with no
    dtype all stay silent."""
    src = """
        import torch
        from somewhere import pool_shape

        def build(quantized, n, wide):
            k_cache = torch.zeros(pool_shape(), dtype=torch.int8)
            if quantized:
                k_scale = torch.zeros(pool_shape())
            else:
                k_scale = None
            shape = (2, n, 4) if wide else (2, n)
            v_cache = torch.zeros((2, n, 4, 8), dtype=torch.int8)
            v_scale = torch.zeros(shape, dtype=torch.bfloat16)
            q_pool = torch.empty(*shape, dtype=torch.int8)
            q_scale = torch.empty(shape[:1], dtype=torch.int32)
            return k_cache, k_scale, v_cache, v_scale, q_pool, q_scale
    """
    assert "RTL804" not in rules_of(lint(src))


RUNNER = "ray_tpu_torch/llm/model_runner.py"
PAGED = "ray_tpu_torch/ops/paged_flash.py"
MUTATIONS = {
    "as_shipped": (RUNNER, None, None, []),
    "scale_shape_cut": (RUNNER, "scale_shape = cache_shape[:-1]",
                        "scale_shape = cache_shape[:2]", ["rank 2"] * 2),
    "scale_int8": (RUNNER, "self.k_scale = zeros(scale_shape, KV_SCALE_DTYPE)",
                   "self.k_scale = zeros(scale_shape, torch.int8)", ["dtype int8"]),
    "scatter_skips_scales": (
        RUNNER,
        "                self.k_scale[layer].index_put_(index, ks)\n"
        "                self.v_scale[layer].index_put_(index, vs)\n",
        "                pass\n", ["never updated"] * 2),
    # The scale dtype reaches the runner as an import from the ops module.
    "scale_dtype_constant_int8": (PAGED, "KV_SCALE_DTYPE = torch.bfloat16",
                                  "KV_SCALE_DTYPE = torch.int8", ["dtype int8"] * 2),
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_rtl804_on_the_model_runner(case, tmp_path):
    """tmp_path copies of the runner and the module its scale dtype comes
    from: silent as shipped, firing on each mutation."""
    target, old, new, want = MUTATIONS[case]
    (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")
    for rel in (RUNNER, PAGED):
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO_ROOT / rel, dst)
    if old is not None:
        text = (tmp_path / target).read_text()
        assert text.count(old) == 1, old
        (tmp_path / target).write_text(text.replace(old, new))
    result = lint_paths([tmp_path / "ray_tpu_torch"], rule_ids=["RTL804"],
                        root=tmp_path)
    assert [f.path for f in result.findings] == [RUNNER] * len(want)
    for f, words in zip(result.findings, want):
        assert words in f.message, f.message


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


def _port_py_files() -> int:
    return sum(
        1 for p in (REPO_ROOT / "ray_tpu_torch").rglob("*.py")
        if not {"__pycache__", "_build"} & set(p.relative_to(REPO_ROOT).parts)
    )


def test_port_is_lint_clean():
    """`python -m ray_tpu_torch.tools.lint ray_tpu_torch` must exit 0:
    every finding on the port is fixed, suppressed with a reason, or
    baselined with a reason in LINT_BASELINE_TORCH.json. The 10 s budget
    is held on the scan's CPU time (its wall time is the card machine's
    phase 22 to hold: six test workers share this host's cores)."""
    baseline = baseline_mod.load_baseline(
        REPO_ROOT / baseline_mod.BASELINE_FILENAME
    )
    cpu0 = time.process_time()
    result = lint_paths(
        [REPO_ROOT / "ray_tpu_torch"], baseline=baseline, root=REPO_ROOT
    )
    cpu_s = time.process_time() - cpu0
    assert result.parse_errors == []
    assert result.findings == [], "\n".join(
        f"{f.path}:{f.line} {f.rule} {f.message}" for f in result.findings
    )
    assert not result.stale_baseline, result.stale_baseline
    assert baseline_mod.untriaged(baseline) == []
    assert cpu_s < 10.0, cpu_s
    assert result.files_scanned >= 210
    assert result.files_scanned == _port_py_files()


def test_build_directories_are_not_scanned(tmp_path):
    """A tree unpacked under a `_build` directory (the card's rehearsal
    unpacks one into ops/_build/tree/) adds no module to the scan."""
    pkg = tmp_path / "pkg"
    (pkg / "ops" / "_build" / "tree").mkdir(parents=True)
    (pkg / "mod.py").write_text("x = 1\n")
    (pkg / "ops" / "_build" / "tree" / "copy.py").write_text(
        "def fire(h):\n    h.ping.remote()\n")
    result = lint_paths([pkg], root=tmp_path)
    assert result.files_scanned == 1 and result.findings == []


def test_baseline_holds_the_reference_reasons():
    """The port's baseline holds the four runtime reads the reference
    baselines for the same code, each with the reference's reason."""
    ref = json.loads((REPO_ROOT / "LINT_BASELINE.json").read_text())["findings"]
    port = json.loads(
        (REPO_ROOT / baseline_mod.BASELINE_FILENAME).read_text())["findings"]
    assert baseline_mod.BASELINE_FILENAME == "LINT_BASELINE_TORCH.json"
    reasons = {(e["rule"], e["context"]): e["reason"] for e in ref}
    assert len(port) == 4
    for e in port:
        assert e["path"] == "ray_tpu_torch/_private/runtime.py"
        assert e["reason"] == reasons[(e["rule"], e["context"])]


def test_every_suppression_in_port_has_reason():
    """The inline-ignore idiom requires a reason everywhere in the port."""
    result = lint_paths(
        [REPO_ROOT / "ray_tpu_torch"], rule_ids=["RTL002"], baseline={},
        root=REPO_ROOT,
    )
    assert result.findings == []
    assert result.files_scanned == _port_py_files()
