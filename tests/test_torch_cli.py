"""The port's CLI (`python -m ray_tpu_torch.scripts.cli`) against the
reference's (`ray_tpu.scripts.cli`).

Every subcommand, driven in process through `main(argv)` where it returns
(`dashboard` and `start` block, so they run as processes and are stopped):
`status`, `list` and `summary` print what the reference's print for the
same seeded program, IDs masked; `train-stats`, `timeline`, `top` and
`metrics` read this process's runtime, and `train-stats --url` and `top
--url` a head's dashboard; `job submit | status | logs | list | stop
--address` and `logs --address` reach a head in another process as a
remote driver; `loadgen` forwards to the harness; `lint` forwards to the
port's analyzer (ray_tpu_torch/tools/lint), whose own cases are in
tests/test_torch_lint.py.
"""

import json
import os
import re
import signal
import subprocess
import sys
import textwrap
import time
import urllib.request

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.scripts import cli as jax_cli
from ray_tpu_torch.scripts import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEX_ID = re.compile(r"[0-9a-f]{16,}")
PACKAGES = {"ray_tpu": (ray_tpu, jax_cli), "ray_tpu_torch": (ray_tpu_torch, cli)}


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))


def _program(rt, seed: int):
    rng = np.random.RandomState(seed)

    @rt.remote
    def scale(x, k):
        return x * k

    @rt.remote
    class Box:
        def __init__(self, v):
            self.v = v

        def get(self):
            return self.v

    xs = rng.randint(0, 50, size=4).tolist()
    assert rt.get([scale.remote(x, 3) for x in xs]) == [3 * x for x in xs]
    box = Box.options(name="box").remote(xs[0])
    assert rt.get(box.get.remote()) == xs[0]
    kept = rt.put(np.arange(xs[1]))
    pg = rt.util.placement_group([{"CPU": 1}], strategy="PACK")
    assert pg.ready(timeout=30)
    return box, kept, pg


def _masked(text: str):
    """The printed JSON with IDs masked and rows sorted (concurrent tasks
    finish in either order), the package's name as the reference's."""
    value = json.loads(HEX_ID.sub("<id>", text.replace("ray_tpu_torch", "ray_tpu")))
    if isinstance(value, list):
        return sorted(value, key=repr)
    return value


STATE_COMMANDS = [["list", "tasks"], ["list", "actors"], ["list", "nodes"],
                  ["list", "objects"], ["list", "placement-groups"], ["summary"]]


def state_outputs(name: str) -> dict:
    """The program on package `name`, then each state command through its
    CLI in process (the command attaches to the running runtime); the
    outputs masked, by command."""
    import contextlib
    import io

    rt, mod = PACKAGES[name]
    rt.init(num_cpus=4, num_gpus=0)
    try:
        keep = _program(rt, 0)
        time.sleep(0.2)  # the tables settle
        out = {}
        for argv in STATE_COMMANDS:
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                assert mod.main(list(argv)) == 0
            out["-".join(argv)] = _masked(text.getvalue())
        del keep
        return out
    finally:
        rt.shutdown()


def in_fresh_process(fn: str, *args):
    """This module's `fn(*args)` in a new interpreter (a test process may
    hold threads of an earlier test's runtime that would add rows of their
    own), its JSON result."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import {mod} as m; "
            "print('RESULT ' + json.dumps(getattr(m, sys.argv[2])(*json.loads(sys.argv[3]))))"
            ).format(mod=os.path.splitext(os.path.basename(__file__))[0])
    proc = subprocess.run([sys.executable, "-c", code, here, fn, json.dumps(args)],
                          capture_output=True, text=True, timeout=240, env=_env())
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(lines[-1][len("RESULT "):])


@pytest.fixture(scope="module")
def state_commands():
    return {name: in_fresh_process("state_outputs", name) for name in PACKAGES}


@pytest.mark.parametrize("argv", STATE_COMMANDS, ids=lambda a: "-".join(a))
def test_state_commands_match_the_reference(argv, state_commands):
    """The same program on both packages, then the same command through
    each package's CLI."""
    key = "-".join(argv)
    assert state_commands["ray_tpu_torch"][key] == state_commands["ray_tpu"][key]
    assert state_commands["ray_tpu_torch"][key]


def test_status_matches_the_reference(capsys):
    """`status` boots its own runtime (8 CPUs), prints, shuts it down."""
    out = {}
    for name, (rt, mod) in PACKAGES.items():
        assert mod.main(["status"]) == 0
        out[name] = capsys.readouterr().out
        assert not rt.is_initialized()
    assert out["ray_tpu_torch"] == out["ray_tpu"]
    assert "Resources:" in out["ray_tpu_torch"] and "CPU: 8/8 available" in out["ray_tpu_torch"]


def test_status_subprocess():
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts.cli", "status"],
                         capture_output=True, text=True, timeout=120, cwd=REPO, env=_env())
    assert out.returncode == 0, out.stderr
    assert "Resources:" in out.stdout


@pytest.mark.parametrize("argv", [["lint"], ["lint", "--json", "ray_tpu_torch"],
                                  ["--num-cpus", "2", "lint"]],
                         ids=["bare", "flags", "global-flag-first"])
def test_lint_is_refused_naming_b15(argv, capsys, monkeypatch):
    """The name is kept from when `lint` was refused; the command now
    forwards to the port's analyzer, which boots no runtime: bare, with
    the analyzer's own flags, and behind a global flag (argparse's
    dispatch), each scans ray_tpu_torch/ from the repo root and exits 0."""
    monkeypatch.chdir(REPO)
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert not ray_tpu_torch.is_initialized()
    if "--json" in argv:
        report = json.loads(out)
        assert report["version"] == 3 and report["paths"] == ["ray_tpu_torch"]
        assert set(report["counts"]) == {
            "active", "baselined", "suppressed", "parse_errors",
            "stale_baseline", "untriaged_baseline",
        }
        assert report["counts"]["active"] == len(report["findings"]) == 0
        assert report["files_scanned"] == report["files_checked"] >= 210
    else:
        assert re.search(r"^0 finding\(s\), \d+ baselined, \d+ suppressed, "
                         r"0 parse error\(s\) in \d+ files", out, re.M), out


def test_local_commands(tmp_path, capsys):
    """train-stats, timeline, top (text and --json) and metrics against the
    runtime of this process; loadgen's report and its device refusal."""
    rt = ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    try:
        keep = _program(ray_tpu_torch, 1)
        capsys.readouterr()
        assert cli.main(["train-stats"]) == 0
        assert json.loads(capsys.readouterr().out) == []
        path = tmp_path / "timeline.json"
        assert cli.main(["timeline", "--output", str(path)]) == 0
        events = json.loads(path.read_text())
        assert f"Wrote {len(events)} trace events" in capsys.readouterr().out
        assert any(str(e.get("name")).endswith("scale") for e in events)
        assert cli.main(["top"]) == 0
        assert "no live llm engines" in capsys.readouterr().out
        assert cli.main(["top", "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["replicas"] == {}
        from ray_tpu_torch.util.runtime_metrics import sample_runtime_metrics

        sample_runtime_metrics(rt)
        assert cli.main(["metrics"]) == 0
        text = capsys.readouterr().out
        assert 'ray_tpu_tasks{state="FINISHED"}' in text and "ray_tpu_nodes_alive 1" in text
        del keep
    finally:
        ray_tpu_torch.shutdown()
    record = tmp_path / "record.json"
    for body, rc in (({"cells": []}, 0), ({"cells": [], "gate_problems": ["x"]}, 1)):
        record.write_text(json.dumps(body))
        assert cli.main(["loadgen", "report", str(record)]) == rc
        assert cli.main(["--num-cpus", "2", "loadgen", "report", str(record)]) == rc
    with pytest.raises(RuntimeError, match="cpu"):
        cli.main(["loadgen", "run", "--num-requests", "1"])  # cuda unless asked
    assert not ray_tpu_torch.is_initialized()


_HEAD = textwrap.dedent(
    """
    import sys, time
    import ray_tpu_torch

    rt = ray_tpu_torch.init(num_cpus=2, num_gpus=0, _system_config={
        "isolation": "process", "worker_device": "cpu",
        "include_dashboard": True, "dashboard_port": 0})
    address = rt.serve_clients(port=0)

    @ray_tpu_torch.remote
    def shout():
        print("cli-head-marker")
        return 1

    assert ray_tpu_torch.get(shout.remote(), timeout=120) == 1
    print("HEAD", address, rt.dashboard.url, flush=True)
    sys.stdin.readline()
    ray_tpu_torch.shutdown()
    """
)


@pytest.fixture
def head():
    """A head in a process of its own (process workers, dashboard on a free
    port, client listener); it shuts down when its stdin line comes."""
    proc = subprocess.Popen([sys.executable, "-c", _HEAD], cwd=REPO, env=_env(), text=True,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    try:
        line = ""
        while not line.startswith("HEAD "):  # the worker's reprinted line may come first
            line = proc.stdout.readline()
            assert line, "the head exited"
        _, address, url = line.split()
        yield address, url
    finally:
        if proc.poll() is None:
            proc.stdin.write("\n")
            proc.stdin.flush()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


def test_remote_commands(head, capsys):
    """job submit | status | logs | list | stop, logs, top --url and
    train-stats --url against a head in another process, each in process
    here as a remote driver that connects and disconnects."""
    address, url = head
    code = "import os; print('job-marker', os.environ['RAY_TPU_TORCH_JOB_ID'])"
    assert cli.main(["job", "submit", "--address", address, "--", sys.executable, "-c",
                     code]) == 0
    out = capsys.readouterr().out
    job_id = re.search(r"Submitted (\S+)", out).group(1)
    assert "Status: SUCCEEDED" in out and f"job-marker {job_id}" in out
    assert cli.main(["job", "status", job_id, "--address", address]) == 0
    assert capsys.readouterr().out.split("\t")[:2] == [job_id, "SUCCEEDED"]
    assert cli.main(["job", "logs", job_id, "--address", address]) == 0
    assert f"job-marker {job_id}" in capsys.readouterr().out
    assert cli.main(["job", "submit", "--address", address, "--no-wait", "--",
                     sys.executable, "-c", "import time; time.sleep(120)"]) == 0
    sleeper = re.search(r"Submitted (\S+)", capsys.readouterr().out).group(1)
    assert cli.main(["job", "list", "--address", address]) == 0
    listed = capsys.readouterr().out
    assert job_id in listed and sleeper in listed
    deadline = time.time() + 60
    while f"{sleeper}\tRUNNING" not in capsys.readouterr().out:
        assert time.time() < deadline
        cli.main(["job", "status", sleeper, "--address", address])
        time.sleep(0.2)
    assert cli.main(["job", "stop", sleeper, "--address", address]) == 0
    assert "Stop requested: True" in capsys.readouterr().out
    assert cli.main(["logs", "--address", address]) == 0
    assert "cli-head-marker" in capsys.readouterr().out
    assert cli.main(["top", "--url", url]) == 0
    assert "no live llm engines" in capsys.readouterr().out
    assert cli.main(["train-stats", "--url", url]) == 0
    assert json.loads(capsys.readouterr().out) == []
    assert not ray_tpu_torch.is_initialized()


def test_dashboard_and_start_commands(head, tmp_path):
    """`dashboard` serves its own demo runtime until interrupted; `start
    --address` runs a node daemon that joins the head, with `--num-gpus`
    (there is no `--num-tpus`)."""
    address, url = head
    cmd = [sys.executable, "-m", "ray_tpu_torch.scripts.cli"]
    dash = subprocess.Popen([*cmd, "dashboard", "--port", "0"], cwd=REPO, env=_env(),
                            text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        line = dash.stdout.readline()
        own = re.search(r"Dashboard at (\S+)", line).group(1)
        with urllib.request.urlopen(own + "/api/cluster", timeout=30) as resp:
            assert json.loads(resp.read())["alive_nodes"] == 1
        dash.send_signal(signal.SIGINT)
        assert dash.wait(timeout=60) == 0
    finally:
        if dash.poll() is None:
            dash.kill()
            dash.wait(timeout=10)
    bad = subprocess.run([*cmd, "start", "--address", address, "--num-tpus", "1"],
                         capture_output=True, text=True, timeout=120, cwd=REPO, env=_env())
    assert bad.returncode != 0 and "--num-tpus" in bad.stderr
    node = subprocess.Popen([*cmd, "start", "--address", address, "--num-cpus", "1",
                             "--num-gpus", "1", "--resources", '{"cliNode": 1}',
                             "--object-store-memory", str(64 << 20)],
                            cwd=REPO, env=_env(), stdout=subprocess.DEVNULL,
                            stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 60
        while True:
            with urllib.request.urlopen(url + "/api/nodes", timeout=30) as resp:
                nodes = json.loads(resp.read())
            joined = [n for n in nodes if "cliNode" in n["resources_total"]]
            if joined:
                break
            assert time.time() < deadline and node.poll() is None
            time.sleep(0.2)
        assert joined[0]["state"] == "ALIVE"
        assert joined[0]["resources_total"] == {"CPU": 1.0, "GPU": 1.0, "cliNode": 1.0}
    finally:
        node.terminate()
        node.wait(timeout=60)
