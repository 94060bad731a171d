"""Job submission — run driver scripts as supervised subprocesses.

Reference: dashboard/modules/job/ — JobManager (job_manager.py:508) spawns a
detached JobSupervisor actor per job which execs the user's entrypoint as a
fate-shared subprocess, streams logs to files, and records status in the GCS
KV; JobSubmissionClient (sdk.py:40) is the user surface. Here the supervisor
is an actor on the head's runtime (a worker process of its own under
isolation="process"); the entrypoint runs as a real subprocess, which may
connect to the head as a remote driver (`init(address=...)`) or run a
runtime of its own; logs land in a per-job file under
$TMPDIR/ray_tpu_torch_job_logs, and status lives in the controller KV so
every API reads the same source of truth. A worker process or a remote
driver reaches that KV by RPC (ROADMAP.md §D30).
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import ray_tpu_torch

# Job status values (reference: job_submission/__init__.py JobStatus).
PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"

_KV_PREFIX = b"job:"


@dataclass
class JobDetails:
    job_id: str
    entrypoint: str
    status: str = PENDING
    message: str = ""
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    metadata: Dict[str, str] = field(default_factory=dict)
    runtime_env: Dict[str, Any] = field(default_factory=dict)
    log_path: str = ""


@ray_tpu_torch.remote
class JobSupervisor:
    """One per job: runs the entrypoint subprocess and updates KV status."""

    def __init__(self, job_id: str, entrypoint: str, runtime_env: dict, log_path: str):
        import threading

        self.job_id = job_id
        self.entrypoint = entrypoint
        self.runtime_env = runtime_env or {}
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self._stopped = False
        self._lock = threading.Lock()

    def run(self) -> str:
        from ray_tpu_torch._private.runtime import get_runtime

        kv = get_runtime().controller
        env = dict(os.environ)
        env.update(self.runtime_env.get("env_vars", {}))
        env["RAY_TPU_TORCH_JOB_ID"] = self.job_id
        cwd = self.runtime_env.get("working_dir") or None
        _update(kv, self.job_id, status=RUNNING, start_time=time.time())
        with open(self.log_path, "ab") as logf:
            # Spawn under the lock so stop() either sees the process or
            # prevents the spawn — never a stop that kills nothing while the
            # entrypoint still launches and runs to completion.
            with self._lock:
                if self._stopped:
                    _update(kv, self.job_id, status=STOPPED, end_time=time.time())
                    return STOPPED
                proc = self.proc = subprocess.Popen(
                    self.entrypoint,
                    shell=True,
                    stdout=logf,
                    stderr=subprocess.STDOUT,
                    env=env,
                    cwd=cwd,
                    start_new_session=True,
                )
            returncode = proc.wait()
        # Under the lock: stop() publishes _stopped before killing the
        # process group, so a wait() woken by that kill must classify as
        # STOPPED, never FAILED-with-SIGTERM.
        with self._lock:
            stopped = self._stopped
        if stopped:
            _update(kv, self.job_id, status=STOPPED, end_time=time.time())
            return STOPPED
        if returncode == 0:
            _update(kv, self.job_id, status=SUCCEEDED, end_time=time.time())
            return SUCCEEDED
        _update(
            kv,
            self.job_id,
            status=FAILED,
            message=f"entrypoint exited with code {returncode}",
            end_time=time.time(),
        )
        return FAILED

    def stop(self) -> bool:
        """Request the job stop. Returns True if the job will not run to
        completion (process killed, or spawn prevented)."""
        import signal

        with self._lock:
            self._stopped = True
            proc = self.proc
        if proc is not None and proc.poll() is None:
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
            except ProcessLookupError:
                pass
            return True
        # Not spawned yet: run() will observe _stopped and skip the spawn.
        return proc is None

    def ping(self) -> str:
        return "pong"


def _store(controller, details: JobDetails) -> None:
    controller.kv_put(
        _KV_PREFIX + details.job_id.encode(),
        json.dumps(details.__dict__).encode(),
    )


def _load(controller, job_id: str) -> Optional[JobDetails]:
    raw = controller.kv_get(_KV_PREFIX + job_id.encode())
    if raw is None:
        return None
    return JobDetails(**json.loads(raw))


def _update(controller, job_id: str, **updates) -> None:
    details = _load(controller, job_id)
    if details is None:
        return
    for k, v in updates.items():
        setattr(details, k, v)
    _store(controller, details)


class JobSubmissionClient:
    """User surface (reference sdk.py:40: submit/stop/status/logs/list).

    It reads the runtime of this process: a head, or a remote driver's
    proxy (`init(address=...)` first; `address` is unused, as in the
    reference). A job's log file is read where this client runs, so
    `get_job_logs` sees it on the head's machine."""

    def __init__(self, address: Optional[str] = None):
        from ray_tpu_torch._private.runtime import get_runtime

        self._runtime = get_runtime()
        self._supervisors: Dict[str, Any] = {}
        self._runs: Dict[str, Any] = {}
        self._log_dir = os.path.join(tempfile.gettempdir(), "ray_tpu_torch_job_logs")
        os.makedirs(self._log_dir, exist_ok=True)

    def submit_job(
        self,
        *,
        entrypoint: str,
        submission_id: Optional[str] = None,
        runtime_env: Optional[dict] = None,
        metadata: Optional[Dict[str, str]] = None,
    ) -> str:
        job_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:16]}"
        if _load(self._runtime.controller, job_id) is not None:
            raise ValueError(f"Job {job_id!r} already exists")
        log_path = os.path.join(self._log_dir, f"{job_id}.log")
        details = JobDetails(
            job_id=job_id,
            entrypoint=entrypoint,
            metadata=metadata or {},
            runtime_env=runtime_env or {},
            log_path=log_path,
        )
        _store(self._runtime.controller, details)
        supervisor = JobSupervisor.options(
            name=f"_job_supervisor:{job_id}", num_cpus=0, max_concurrency=4
        ).remote(job_id, entrypoint, runtime_env or {}, log_path)
        self._supervisors[job_id] = supervisor
        self._runs[job_id] = supervisor.run.remote()
        return job_id

    def get_job_status(self, job_id: str) -> str:
        details = _load(self._runtime.controller, job_id)
        if details is None:
            raise KeyError(f"No such job {job_id!r}")
        return details.status

    def get_job_info(self, job_id: str) -> JobDetails:
        details = _load(self._runtime.controller, job_id)
        if details is None:
            raise KeyError(f"No such job {job_id!r}")
        return details

    def get_job_logs(self, job_id: str) -> str:
        details = self.get_job_info(job_id)
        if details.log_path and os.path.exists(details.log_path):
            with open(details.log_path, "r", errors="replace") as f:
                return f.read()
        return ""

    def list_jobs(self) -> List[JobDetails]:
        out = []
        for key in self._runtime.controller.kv_keys(_KV_PREFIX):
            job_id = key[len(_KV_PREFIX) :].decode()
            details = _load(self._runtime.controller, job_id)
            if details is not None:
                out.append(details)
        return sorted(out, key=lambda d: d.start_time or 0)

    def stop_job(self, job_id: str) -> bool:
        """Stop a job this client submitted, or, by its supervisor's name,
        one another client did (the reference knows only its own)."""
        supervisor = self._supervisors.get(job_id)
        if supervisor is None:
            try:
                supervisor = ray_tpu_torch.get_actor(f"_job_supervisor:{job_id}")
            except ValueError:
                raise KeyError(f"No supervisor for job {job_id!r}") from None
        return ray_tpu_torch.get(supervisor.stop.remote(), timeout=10.0)

    def wait_until_finish(
        self, job_id: str, timeout: float = 300.0, poll_s: float = 0.2
    ) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(job_id)
            if status in (SUCCEEDED, FAILED, STOPPED):
                return status
            time.sleep(poll_s)
        raise TimeoutError(f"Job {job_id} still {status} after {timeout}s")

    def delete_job(self, job_id: str) -> bool:
        details = _load(self._runtime.controller, job_id)
        if details is None:
            return False
        if details.status in (PENDING, RUNNING):
            raise RuntimeError("Stop the job before deleting it")
        self._runtime.controller.kv_del(_KV_PREFIX + job_id.encode())
        self._supervisors.pop(job_id, None)
        return True
