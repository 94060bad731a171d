"""`ray-tpu-torch` CLI — status / state listing / jobs / logs / nodes.

Reference: python/ray/scripts/scripts.py (`ray status`, `ray list ...` via
util/state/state_cli.py, `ray job submit` via the job CLI, `ray timeline`).
Run it as `python -m ray_tpu_torch.scripts.cli <command>`. The state
commands bootstrap a local runtime (configurable with --num-cpus), run the
command, and shut down. The commands that take `--address` (`job status |
logs | list | stop`, `job submit --address`, `logs`, `start`) reach a
running head over the client protocol, and `top --url` / `train-stats
--url` poll its dashboard. `lint` is refused: the analyzer is not ported
(ROADMAP.md §B15).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional


def _init(args) -> None:
    import ray_tpu_torch

    # ignore_reinit_error: handlers are also driven in-process against an
    # already-running runtime (tests, embedding scripts); standalone CLI
    # invocations still bootstrap their own.
    ray_tpu_torch.init(
        num_cpus=getattr(args, "num_cpus", None) or 8,
        ignore_reinit_error=True,
    )


def cmd_status(args) -> int:
    import ray_tpu_torch

    _init(args)
    total = ray_tpu_torch.cluster_resources()
    avail = ray_tpu_torch.available_resources()
    nodes = ray_tpu_torch.nodes()
    print(f"Nodes: {len(nodes)}")
    print("Resources:")
    for name in sorted(total):
        print(f"  {name}: {avail.get(name, 0.0):g}/{total[name]:g} available")
    ray_tpu_torch.shutdown()
    return 0


def cmd_list(args) -> int:
    from ray_tpu_torch.util import state as state_api

    _init(args)
    fn = {
        "tasks": state_api.list_tasks,
        "actors": state_api.list_actors,
        "nodes": state_api.list_nodes,
        "objects": state_api.list_objects,
        "placement-groups": state_api.list_placement_groups,
    }[args.what]
    rows = fn()
    print(json.dumps(rows, indent=2, default=str))
    return 0


def cmd_summary(args) -> int:
    from ray_tpu_torch.util.state import summarize_actors, summarize_tasks

    _init(args)
    print(
        json.dumps(
            {"tasks": summarize_tasks(), "actors": summarize_actors()},
            indent=2,
        )
    )
    return 0


def cmd_train_stats(args) -> int:
    """Training telemetry: recent fit() runs with per-phase breakdowns and
    straggler flags. With --url, queries a running head's dashboard
    /api/train (the persistent-cluster path); without, reads this
    process's run registry (fresh CLI runtimes have none — useful mainly
    from scripts that just ran a trainer in-process)."""
    if args.url:
        import urllib.request

        url = args.url.rstrip("/") + f"/api/train?rounds={args.rounds}"
        with urllib.request.urlopen(url, timeout=10) as resp:
            runs = json.loads(resp.read().decode())
    else:
        # The run registry is process-local: no runtime needed to read it.
        from ray_tpu_torch.train.observability import list_runs

        runs = list_runs(rounds_limit=args.rounds)
    print(json.dumps(runs, indent=2, default=str))
    return 0


_LEDGER_COLS = (
    "idle_s", "prefill_s", "fabric_wait_s", "host_schedule_s",
    "device_s", "commit_s", "other_s", "loop_s",
)


def _print_fleet(snap: dict) -> None:
    replicas = snap.get("replicas") or {}
    if not replicas:
        print("no live llm engines")
        return
    short = [c[:-2] for c in _LEDGER_COLS]  # strip the _s suffix
    header = (
        f"{'replica':<28} {'wall':>8} "
        + " ".join(f"{c:>9}" for c in short)
        + f" {'sum/wall':>8} {'tok/s':>8} {'mfu':>6}"
    )
    print(header)
    for name, row in sorted(replicas.items()):
        if "error" in row:
            print(f"{name:<28} error: {row['error']}")
            continue
        ledger = row["ledger"]
        fr = ledger.get("fractions") or {}
        pct = lambda x: f"{100 * x:8.1f}%" if x is not None else "       —"
        cells = " ".join(pct(fr.get(c)) for c in _LEDGER_COLS)
        cov = ledger.get("coverage")
        mfu = ledger.get("mfu")
        print(
            f"{name:<28} {ledger['wall_s']:7.2f}s {cells}"
            f" {pct(cov)} {ledger['goodput_tokens_per_s']:8.1f}"
            f" {('%5.1f%%' % (100 * mfu)) if mfu is not None else '    —'}"
        )
    fleet = snap.get("fleet") or {}
    tops = ", ".join((fleet.get("bottlenecks") or [])[:3]) or "—"
    print(
        f"fleet: {fleet.get('replicas', 0)} replicas · "
        f"{fleet.get('goodput_tokens_per_s', 0.0):.1f} tok/s · "
        f"top columns: {tops}"
    )
    for metric, p in (snap.get("percentiles") or {}).items():
        p50 = p.get("p50")
        p99 = p.get("p99")
        fmt = lambda v: f"{1e3 * v:.1f}ms" if v is not None else "—"
        print(f"  {metric}: p50 {fmt(p50)} p99 {fmt(p99)} (n={p['count']})")


def cmd_top(args) -> int:
    """Fleet time ledger: where every replica's wall time went
    (host-schedule / device / commit / fabric-wait / idle / loop), with
    goodput and MFU. With --url, polls a running head's dashboard
    /api/fleet; without, scrapes this process's runtime directly (useful
    from scripts that just served in-process)."""
    import time as _time

    def _fetch() -> dict:
        if args.url:
            import urllib.request

            url = args.url.rstrip("/") + f"/api/fleet?steps={args.steps}"
            with urllib.request.urlopen(url, timeout=10) as resp:
                return json.loads(resp.read().decode())
        from ray_tpu_torch.observability import fleet_snapshot

        return fleet_snapshot(steps_limit=args.steps)

    if not args.url:
        _init(args)
    try:
        while True:
            snap = _fetch()
            if args.json:
                print(json.dumps(snap, indent=2, default=str))
            else:
                _print_fleet(snap)
            if not args.watch:
                break
            _time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0


def cmd_timeline(args) -> int:
    import ray_tpu_torch

    _init(args)
    trace_id = getattr(args, "trace_id", None)
    out = ray_tpu_torch.timeline(args.output, trace_id=trace_id)
    if trace_id is not None:
        n = len(out.get("traceEvents", []))
        print(
            f"Wrote {n} trace events for trace {trace_id} to "
            f"{args.output} (load at https://ui.perfetto.dev)"
        )
    else:
        print(f"Wrote {len(out)} trace events to {args.output}")
    return 0


def _job_line(details) -> str:
    return (f"{details.job_id}\t{details.status}\t{details.entrypoint}"
            + (f"\t{details.message}" if details.message else ""))


def cmd_job(args) -> int:
    """`job submit` without --address boots a local runtime and waits for
    the entrypoint, as the reference does. With --address it submits to a
    running head as a remote driver and waits unless --no-wait. `job status
    | logs | list | stop` read that head's job table (--address)."""
    import ray_tpu_torch
    from ray_tpu_torch.job_submission import JobSubmissionClient

    address = getattr(args, "address", None)
    if address is not None:
        ray_tpu_torch.init(address=address)
    else:
        _init(args)
    client = JobSubmissionClient()
    try:
        if args.job_cmd == "submit":
            import shlex

            parts = list(args.entrypoint)
            if parts and parts[0] == "--":
                parts = parts[1:]
            # shlex.join keeps arguments with spaces (python -c "...") intact
            # through the supervisor's shell.
            entrypoint = shlex.join(parts)
            env = {"env_vars": dict(kv.split("=", 1) for kv in args.env or [])}
            job_id = client.submit_job(entrypoint=entrypoint, runtime_env=env)
            print(f"Submitted {job_id}")
            # A local runtime (and its job table) lives only as long as this
            # process, so without --address the CLI always waits.
            if address is not None and args.no_wait:
                return 0
            status = client.wait_until_finish(job_id, timeout=args.timeout)
            print(f"Status: {status}")
            sys.stdout.write(client.get_job_logs(job_id))
            return 0 if status == "SUCCEEDED" else 1
        if args.job_cmd == "status":
            info = client.get_job_info(args.job_id)
            print(_job_line(info))
            return 0
        if args.job_cmd == "logs":
            sys.stdout.write(client.get_job_logs(args.job_id))
            return 0
        if args.job_cmd == "list":
            for details in client.list_jobs():
                print(_job_line(details))
            return 0
        if args.job_cmd == "stop":
            stopped = client.stop_job(args.job_id)
            print(f"Stop requested: {stopped}")
            return 0 if stopped else 1
        raise SystemExit(f"unknown job command {args.job_cmd!r}")
    finally:
        ray_tpu_torch.shutdown()


def cmd_metrics(args) -> int:
    from ray_tpu_torch.util.metrics import prometheus_text

    _init(args)
    sys.stdout.write(prometheus_text())
    return 0


def cmd_logs(args) -> int:
    """Tail aggregated worker logs (reference: `ray logs` +
    log_monitor-fed dashboard log view). With --address, queries a running
    head over the client protocol; without, there is no persistent cluster
    to read from, so --address is required."""
    import time as _time

    import ray_tpu_torch
    from ray_tpu_torch._private.runtime import get_runtime

    ray_tpu_torch.init(address=args.address)
    runtime = get_runtime()
    # This command polls get_logs itself; pushed batches would double-print.
    runtime._client_core.print_pushed_logs = False
    after = 0
    try:
        while True:
            reply = runtime._client_core.rpc(
                "get_logs",
                {
                    "node_id": args.node_id,
                    "wid": args.wid,
                    "after_seq": after,
                    "limit": 1000,
                },
            )
            rows = reply["rows"]
            for row in rows:
                after = max(after, row["seq"])
                print(
                    f"(wid={row['wid']} pid={row['pid']}, "
                    f"node={row['hostname']}) [{row['stream']}] {row['line']}"
                )
            if not args.follow:
                break
            _time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    ray_tpu_torch.shutdown()
    return 0


def cmd_dashboard(args) -> int:
    """Serve the web dashboard for a local demo runtime (when a head runs
    in-process, init(include_dashboard=True) serves it from the head
    itself)."""
    import time as _time

    import ray_tpu_torch
    from ray_tpu_torch._private.runtime import get_runtime

    ray_tpu_torch.init(
        num_cpus=getattr(args, "num_cpus", None) or 8,
        _system_config={
            "include_dashboard": True,
            "dashboard_port": args.port,
            "dashboard_host": args.host,
        },
    )
    print(f"Dashboard at {get_runtime().dashboard.url} (Ctrl-C to stop)")
    try:
        while True:
            _time.sleep(3600)
    except KeyboardInterrupt:
        pass
    ray_tpu_torch.shutdown()
    return 0


def cmd_start(args) -> int:
    """Join an existing head as a worker node (`ray start --address=...`,
    reference: services.py:1353 start_raylet). Blocks until the head goes
    away; the daemon fate-shares with its connection."""
    from ray_tpu_torch._private import node_daemon

    daemon_args = ["--address", args.address]
    if args.num_cpus is not None:
        daemon_args += ["--num-cpus", str(args.num_cpus)]
    if args.num_gpus is not None:
        daemon_args += ["--num-gpus", str(args.num_gpus)]
    if args.resources:
        daemon_args += ["--resources", args.resources]
    if args.labels:
        daemon_args += ["--labels", args.labels]
    if args.object_store_memory:
        daemon_args += ["--object-store-memory", str(args.object_store_memory)]
    node_daemon.main(daemon_args)
    return 0


LINT_REFUSAL = (
    "lint: the static analyzer is not ported to ray_tpu_torch "
    "(ROADMAP.md §B15)"
)


def cmd_lint(args) -> int:
    """Refused: the reference's analyzer (ray_tpu/tools/lint) reads JAX
    programs, and its port is ROADMAP.md §B15."""
    print(LINT_REFUSAL, file=sys.stderr)
    return 2


def _forward_loadgen(rest: list) -> int:
    """Hand everything after `loadgen` to the traffic harness's own
    parser (ray_tpu_torch/loadgen/sweep.py): `run` one scenario/rate cell,
    `sweep` the knob space into a BENCH_SERVE record, `report` an
    existing record. The harness boots its own runtime."""
    from ray_tpu_torch.loadgen.sweep import main as loadgen_main

    rest = list(rest)
    if rest and rest[0] == "--":
        rest = rest[1:]
    return loadgen_main(rest)


def cmd_loadgen(args) -> int:
    return _forward_loadgen(args.loadgen_args)


def main(argv: Optional[list] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "lint":
        # Refused before argparse sees the analyzer's flags (`lint --json`).
        return cmd_lint(None)
    if argv and argv[0] == "loadgen":
        # Forward verbatim when `loadgen` leads: the harness owns its flags
        # (`loadgen sweep --quick` must reach its parser — argparse.REMAINDER
        # only engages after a positional). With global flags before the
        # subcommand, argparse dispatches to cmd_loadgen.
        return _forward_loadgen(argv[1:])
    parser = argparse.ArgumentParser(
        prog="ray-tpu-torch",
        description="CLI of ray_tpu_torch, the PyTorch/CUDA port of ray_tpu",
    )
    parser.add_argument("--num-cpus", type=int, default=None)
    sub = parser.add_subparsers(dest="cmd", required=True)

    sub.add_parser("status", help="cluster resources")

    p_list = sub.add_parser("list", help="list cluster state")
    p_list.add_argument(
        "what",
        choices=["tasks", "actors", "nodes", "objects", "placement-groups"],
    )

    sub.add_parser("summary", help="task + actor summaries by name:state")

    p_ts = sub.add_parser(
        "train-stats", help="recent training runs: rounds, phases, stragglers"
    )
    p_ts.add_argument(
        "--url", default=None, help="dashboard base URL of a running head"
    )
    p_ts.add_argument("--rounds", type=int, default=8)

    p_tl = sub.add_parser("timeline", help="export chrome trace")
    p_tl.add_argument("--output", default="timeline.json")
    p_tl.add_argument(
        "--trace-id",
        default=None,
        help="export ONE request's connected Perfetto timeline "
        "(per-actor rows + flow events) instead of the cluster trace",
    )

    p_top = sub.add_parser(
        "top", help="fleet time ledger: wall-time breakdown per replica"
    )
    p_top.add_argument(
        "--url", default=None, help="dashboard base URL of a running head"
    )
    p_top.add_argument("--steps", type=int, default=512)
    p_top.add_argument("--json", action="store_true")
    p_top.add_argument(
        "--watch", action="store_true", help="refresh continuously"
    )
    p_top.add_argument("--interval", type=float, default=2.0)

    p_job = sub.add_parser("job", help="job submission")
    job_sub = p_job.add_subparsers(dest="job_cmd", required=True)
    address_help = "head connect string host:port?token=..."
    p_submit = job_sub.add_parser("submit")
    p_submit.add_argument("--address", default=None, help=address_help)
    p_submit.add_argument("--no-wait", action="store_true",
                          help="with --address: return once submitted")
    p_submit.add_argument("--env", action="append", help="KEY=VALUE", default=None)
    p_submit.add_argument("--timeout", type=float, default=3600.0)
    p_submit.add_argument("entrypoint", nargs=argparse.REMAINDER)
    for name in ("status", "logs", "stop"):
        p = job_sub.add_parser(name)
        p.add_argument("job_id")
        p.add_argument("--address", required=True, help=address_help)
    job_sub.add_parser("list").add_argument(
        "--address", required=True, help=address_help)

    sub.add_parser("metrics", help="prometheus exposition dump")

    p_lint = sub.add_parser(
        "lint", help="refused: the analyzer is not ported (ROADMAP.md §B15)"
    )
    p_lint.add_argument("lint_args", nargs=argparse.REMAINDER)

    p_lg = sub.add_parser(
        "loadgen",
        help="open-loop serving load generator: run / sweep / report",
    )
    p_lg.add_argument(
        "loadgen_args",
        nargs=argparse.REMAINDER,
        help="subcommand and flags forwarded to the harness "
        "(run --rate ..., sweep --quick, report FILE)",
    )

    p_logs = sub.add_parser("logs", help="tail aggregated worker logs")
    p_logs.add_argument(
        "--address", required=True, help="head connect string host:port?token=..."
    )
    p_logs.add_argument("--node-id", default=None)
    p_logs.add_argument("--wid", type=int, default=None)
    p_logs.add_argument("--follow", "-f", action="store_true")

    p_dash = sub.add_parser("dashboard", help="serve the web dashboard")
    p_dash.add_argument("--port", type=int, default=8265)
    p_dash.add_argument("--host", default="127.0.0.1")

    p_start = sub.add_parser(
        "start", help="join a head as a worker node (node daemon)"
    )
    p_start.add_argument(
        "--address", required=True, help="head connect string host:port?token=..."
    )
    p_start.add_argument("--num-cpus", type=float, default=None)
    p_start.add_argument("--num-gpus", type=float, default=None)
    p_start.add_argument("--resources", default=None, help="extra resources JSON")
    p_start.add_argument("--labels", default=None, help="node labels JSON")
    p_start.add_argument("--object-store-memory", type=int, default=None)

    args = parser.parse_args(argv)
    handler = {
        "status": cmd_status,
        "list": cmd_list,
        "summary": cmd_summary,
        "train-stats": cmd_train_stats,
        "timeline": cmd_timeline,
        "top": cmd_top,
        "job": cmd_job,
        "metrics": cmd_metrics,
        "lint": cmd_lint,
        "loadgen": cmd_loadgen,
        "start": cmd_start,
        "logs": cmd_logs,
        "dashboard": cmd_dashboard,
    }[args.cmd]
    return handler(args)


if __name__ == "__main__":
    raise SystemExit(main())
