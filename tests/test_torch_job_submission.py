"""The port's job submission (ray_tpu_torch.job_submission) against the
reference's.

The counterparts of tests/test_observability.py's job tests (end to end,
failure with env vars, stop) and of its CLI round trip, on ray_tpu_torch;
the same entrypoints through both packages give the same status, message,
metadata and log; then what the port adds (ROADMAP.md §D30): the
supervisor runs in a worker process under isolation="process" and reaches
the head's KV by RPC, and a remote driver's client lists, reads, and stops
the head's jobs, as the CLI's `job status | logs | list | stop --address`
do.
"""

import os
import subprocess
import sys
import time

import pytest

import ray_tpu
import ray_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))


@pytest.fixture
def port_runtime():
    runtime = ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield runtime
    ray_tpu_torch.shutdown()


def test_job_submission_end_to_end(port_runtime):
    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient()
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('job says hi')\"",
        metadata={"owner": "test"},
    )
    status = client.wait_until_finish(job_id, timeout=60.0)
    assert status == "SUCCEEDED"
    assert "job says hi" in client.get_job_logs(job_id)
    info = client.get_job_info(job_id)
    assert info.metadata == {"owner": "test"}
    assert os.path.basename(os.path.dirname(info.log_path)) == "ray_tpu_torch_job_logs"
    assert any(j.job_id == job_id for j in client.list_jobs())
    assert client.delete_job(job_id)
    with pytest.raises(KeyError):
        client.get_job_status(job_id)


def test_job_failure_and_env_vars(port_runtime):
    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient()
    job_id = client.submit_job(
        entrypoint=f"{sys.executable} -c \"import os,sys; print(os.environ['MY_FLAG']); "
                   "print(os.environ['RAY_TPU_TORCH_JOB_ID']); sys.exit(3)\"",
        runtime_env={"env_vars": {"MY_FLAG": "flag-value"}},
    )
    status = client.wait_until_finish(job_id, timeout=60.0)
    assert status == "FAILED"
    assert "exited with code 3" in client.get_job_info(job_id).message
    logs = client.get_job_logs(job_id)
    assert "flag-value" in logs and job_id in logs
    running = client.submit_job(entrypoint=f"{sys.executable} -c \"import time; time.sleep(60)\"")
    with pytest.raises(RuntimeError):  # a finished job deletes; a running one does not
        client.delete_job(running)
    client.stop_job(running)
    assert client.wait_until_finish(running, timeout=30.0) == "STOPPED"


def test_job_stop(port_runtime):
    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient()
    job_id = client.submit_job(entrypoint=f"{sys.executable} -c \"import time; time.sleep(60)\"")
    deadline = time.time() + 20
    while time.time() < deadline:
        if client.get_job_status(job_id) == "RUNNING":
            break
        time.sleep(0.1)
    assert client.stop_job(job_id)
    assert client.wait_until_finish(job_id, timeout=30.0) == "STOPPED"


def test_cli_job_submit_roundtrip():
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "job", "submit",
         "--env", "CLI_FLAG=yes", "--",
         sys.executable, "-c", "import os; print(os.environ['CLI_FLAG'])"],
        capture_output=True, text=True, timeout=180, cwd=REPO, env=_env(),
    )
    assert out.returncode == 0, out.stderr
    assert "SUCCEEDED" in out.stdout
    assert "yes" in out.stdout


ENTRYPOINTS = {
    "ok": "import sys; print('seven', 3 + 4)",
    "fails": "import sys; print('bad'); sys.exit(5)",
    "env": "import os; print(os.environ['JOB_SEED'])",
}


def test_jobs_match_the_reference():
    """The same three entrypoints (one succeeds, one exits 5, one reads its
    env) through both packages' clients: the same status, message, metadata,
    log text and listing."""
    got = {}
    for pkg, mod in ((ray_tpu, "ray_tpu.job_submission"),
                     (ray_tpu_torch, "ray_tpu_torch.job_submission")):
        pkg.init(num_cpus=4, num_gpus=0)
        try:
            client = __import__(mod, fromlist=["_"]).JobSubmissionClient()
            ids = {name: client.submit_job(
                entrypoint=f"{sys.executable} -c \"{code}\"", submission_id=f"job-{name}",
                runtime_env={"env_vars": {"JOB_SEED": "1234"}}, metadata={"k": name})
                for name, code in ENTRYPOINTS.items()}
            with pytest.raises(ValueError, match="already exists"):
                client.submit_job(entrypoint="true", submission_id="job-ok")
            rows = {}
            for name, job_id in ids.items():
                status = client.wait_until_finish(job_id, timeout=60.0)
                info = client.get_job_info(job_id)
                rows[name] = (status, info.message, info.metadata, info.entrypoint,
                              client.get_job_logs(job_id))
            rows["listed"] = sorted(j.job_id for j in client.list_jobs())
            got[pkg.__name__] = rows
        finally:
            pkg.shutdown()
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    assert got["ray_tpu_torch"]["fails"][:2] == ("FAILED", "entrypoint exited with code 5")


def test_process_supervisor_and_remote_client():
    """Under isolation="process" the supervisor actor runs in a worker
    process and updates the head's job table by RPC (the reference's fails
    there, §D30). A remote driver's client, and the CLI with --address,
    read that table, the job's log, and stop a job the head submitted."""
    from ray_tpu_torch.job_submission import JobSubmissionClient

    runtime = ray_tpu_torch.init(num_cpus=2, num_gpus=0, _system_config={
        "isolation": "process", "worker_device": "cpu"})
    address = runtime.serve_clients(port=0)
    try:
        client = JobSubmissionClient()
        done = client.submit_job(entrypoint=f"{sys.executable} -c \"print('from a job')\"")
        assert client.wait_until_finish(done, timeout=120.0) == "SUCCEEDED"
        record = next(a for a in runtime.controller.list_actors()
                      if a.class_name == "JobSupervisor")
        assert record.state.value == "ALIVE"
        sleeper = client.submit_job(
            entrypoint=f"{sys.executable} -c \"import time; time.sleep(120)\"")
        deadline = time.time() + 60
        while client.get_job_status(sleeper) != "RUNNING":
            assert time.time() < deadline
            time.sleep(0.1)
        cli = [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "job"]
        run = lambda *a: subprocess.run([*cli, *a, "--address", address], capture_output=True,
                                        text=True, timeout=120, cwd=REPO, env=_env())
        status = run("status", done)
        assert status.returncode == 0 and "SUCCEEDED" in status.stdout, status.stderr
        logs = run("logs", done)
        assert logs.returncode == 0 and "from a job" in logs.stdout, logs.stderr
        listed = run("list")
        assert listed.returncode == 0 and done in listed.stdout and sleeper in listed.stdout
        stop = run("stop", sleeper)
        assert stop.returncode == 0 and "True" in stop.stdout, stop.stderr
        assert client.wait_until_finish(sleeper, timeout=30.0) == "STOPPED"
        missing = run("status", "no-such-job")
        assert missing.returncode != 0 and "no-such-job" in missing.stderr
    finally:
        ray_tpu_torch.shutdown()
