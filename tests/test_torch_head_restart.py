"""The port's head (GCS) restart with live daemon reconnection.

The case of tests/test_head_restart.py, on ray_tpu_torch and in tier-1,
with short windows: a head process is SIGKILLed mid-session, the node
daemon survives (its reconnect window), a restarted head on the same
port+token restores the GCS snapshot, the daemon re-registers, the restored
detached actor schedules back onto it, and fresh tasks run — all without
the daemon process restarting. The head's script is written into the
test's temporary directory.

What the port adds to the reference's case: the detached actor serves a
2-layer GPT built from a seed on device="cpu" before and after the restart,
and its tokens are identical (tolerance: none); a KV entry comes back with
equal bytes and the job counter moves on.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN = "restarttok"
RECONNECT_WINDOW_S = 30
GRACE_S = 20

HEAD_SCRIPT = textwrap.dedent(
    """
    import argparse
    import json
    import time

    import ray_tpu_torch

    KV = b"\\x00restart-kv\\xff" * 3
    PROMPTS = [[5, 17, 99, 3], [64, 2, 2, 8, 120, 7, 1]]


    class Survivor:
        def __init__(self, seed):
            import os

            import torch

            from ray_tpu_torch.llm import EngineConfig, LLMServer
            from ray_tpu_torch.models.gpt import GPTConfig

            torch.set_num_threads(1)
            cfg = GPTConfig(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64,
                            max_seq_len=64, dtype=torch.float32,
                            attention_impl="reference")
            ecfg = EngineConfig(block_size=8, num_blocks=32, max_decode_slots=2,
                                max_blocks_per_seq=8)
            self.server = LLMServer(cfg, ecfg, seed=seed, device="cpu", warmup=False)
            self.pid = os.getpid()

        def ping(self):
            return ("alive", self.pid)

        def tokens(self):
            return [self.server.generate(p, max_new_tokens=4)["token_ids"]
                    for p in PROMPTS]


    def main():
        parser = argparse.ArgumentParser()
        parser.add_argument("--port", type=int, required=True)
        parser.add_argument("--gcs", required=True)
        parser.add_argument("--token", required=True)
        parser.add_argument("--grace", type=float, required=True)
        parser.add_argument("--phase", choices=["first", "second"], required=True)
        args = parser.parse_args()

        runtime = ray_tpu_torch.init(
            num_cpus=1,
            num_gpus=0,
            _system_config={
                "isolation": "process",
                "worker_device": "cpu",
                "gcs_storage_path": args.gcs,
                "head_restart_grace_s": args.grace,
            },
        )
        runtime.serve_clients(port=args.port, token=args.token)
        print(f"JOB {runtime.job_id.to_int()}", flush=True)

        if args.phase == "first":
            deadline = time.monotonic() + 60
            while (
                len(runtime.controller.alive_nodes()) < 2
                and time.monotonic() < deadline
            ):
                time.sleep(0.2)
            assert len(runtime.controller.alive_nodes()) == 2, "daemon never joined"
            runtime.controller.kv_put(b"restart_kv", KV)
            cls = ray_tpu_torch.remote(Survivor).options(
                name="survivor", lifetime="detached", resources={"dnode": 0.1})
            cls.remote(0)
            handle = ray_tpu_torch.get_actor("survivor")
            _, pid = ray_tpu_torch.get(handle.ping.remote(), timeout=120)
            print(f"ACTOR_PID {pid}", flush=True)
            print("TOKENS " + json.dumps(ray_tpu_torch.get(handle.tokens.remote(),
                                                           timeout=120)), flush=True)
            # Force the snapshot NOW: the crash must not race the debounced flush.
            from ray_tpu_torch._private.gcs_storage import build_snapshot

            runtime._gcs_storage.save(build_snapshot(runtime))
            print("READY", flush=True)
            time.sleep(600)  # the test SIGKILLs us here
        else:
            kv = runtime.controller.kv_get(b"restart_kv")
            print("KV " + (kv.hex() if kv is not None else "none"), flush=True)
            deadline = time.monotonic() + 90
            while time.monotonic() < deadline:
                try:
                    handle = ray_tpu_torch.get_actor("survivor")
                    state, pid = ray_tpu_torch.get(handle.ping.remote(), timeout=30)
                    print(f"SURVIVOR {state} {pid}", flush=True)
                    break
                except Exception:
                    time.sleep(0.5)
            else:
                print("FAILED no survivor", flush=True)
                raise SystemExit(1)
            print("TOKENS " + json.dumps(ray_tpu_torch.get(handle.tokens.remote(),
                                                           timeout=120)), flush=True)

            @ray_tpu_torch.remote(resources={"dnode": 0.1})
            def on_daemon():
                import os

                return os.getppid()

            print(f"TASKPPID {ray_tpu_torch.get(on_daemon.remote(), timeout=60)}",
                  flush=True)
            print("DONE", flush=True)
            ray_tpu_torch.shutdown()


    if __name__ == "__main__":
        main()
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _LineReader:
    """Background reader so subprocess stdout never blocks the pipe."""

    def __init__(self, proc: subprocess.Popen):
        self.lines: list[str] = []
        self._cond = threading.Condition()
        self._proc = proc
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self) -> None:
        for line in self._proc.stdout:
            with self._cond:
                self.lines.append(line.rstrip("\n"))
                self._cond.notify_all()

    def wait_for(self, prefix: str, timeout: float) -> str:
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                for line in self.lines:
                    if line.startswith(prefix):
                        return line
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"no {prefix!r} from subprocess; got {self.lines!r}"
                    )
                self._cond.wait(timeout=min(left, 0.5))


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def _spawn_head(script: str, phase: str, port: int, gcs: str) -> tuple:
    proc = subprocess.Popen(
        [sys.executable, script, "--phase", phase, "--port", str(port),
         "--gcs", gcs, "--token", TOKEN, "--grace", str(GRACE_S)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, _LineReader(proc)


def test_head_restart_daemon_reconnects(tmp_path):
    script = tmp_path / "head_script.py"
    script.write_text(HEAD_SCRIPT)
    port = _free_port()
    gcs = str(tmp_path / "gcs.snap")
    head1 = head2 = daemon = None
    try:
        head1, head1_out = _spawn_head(str(script), "first", port, gcs)
        # The daemon dials the head once at start: only after it listens.
        first_job = int(head1_out.wait_for("JOB", timeout=60).split()[1])
        daemon = subprocess.Popen(
            [
                sys.executable, "-m", "ray_tpu_torch._private.node_daemon",
                "--address", f"127.0.0.1:{port}?token={TOKEN}",
                "--num-cpus", "4",
                "--resources", '{"dnode": 1}',
                "--object-store-memory", str(256 << 20),
                "--reconnect-window", str(RECONNECT_WINDOW_S),
            ],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        daemon_out = _LineReader(daemon)

        actor_line = head1_out.wait_for("ACTOR_PID", timeout=120)
        old_actor_pid = int(actor_line.split()[1])
        tokens_before = json.loads(head1_out.wait_for("TOKENS", 60).split(" ", 1)[1])
        head1_out.wait_for("READY", timeout=30)

        # Control-plane CRASH: no shutdown frames reach the daemon.
        head1.kill()
        head1.wait(timeout=10)
        daemon_out.wait_for("daemon: head connection lost", timeout=30)
        assert daemon.poll() is None, "daemon died with the head (fate-shared)"

        head2, head2_out = _spawn_head(str(script), "second", port, gcs)
        second_job = int(head2_out.wait_for("JOB", timeout=60).split()[1])
        assert second_job > first_job  # the counter survived
        kv = head2_out.wait_for("KV", timeout=30).split()[1]
        assert bytes.fromhex(kv) == b"\x00restart-kv\xff" * 3
        survivor = head2_out.wait_for("SURVIVOR", timeout=120)
        _, state, new_actor_pid = survivor.split()
        assert state == "alive"
        daemon_out.wait_for("daemon: rejoined head", timeout=10)
        tokens_after = json.loads(head2_out.wait_for("TOKENS", 60).split(" ", 1)[1])
        assert tokens_after == tokens_before  # seeded again: identical
        # Fresh worker process for the restored actor (state is rebuilt, the
        # reference's restart semantics), hosted by the SAME daemon.
        task_line = head2_out.wait_for("TASKPPID", timeout=60)
        assert int(task_line.split()[1]) == daemon.pid, (
            "task did not run under the original daemon process"
        )
        head2_out.wait_for("DONE", timeout=60)
        assert int(new_actor_pid) != old_actor_pid  # old worker was orphaned
        assert head2.wait(timeout=30) == 0
        # Clean head shutdown → explicit fate-sharing: daemon exits promptly.
        assert daemon.wait(timeout=15) is not None, "daemon ignored clean head shutdown"
    finally:
        for proc in (head1, head2, daemon):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        # A killed (or failed) head or daemon cannot remove its shm segment,
        # which is named by its pid.
        for proc, name in ((head1, "ray_tpu_torch_{}"), (head2, "ray_tpu_torch_{}"),
                           (daemon, "ray_tpu_torch_node_{}")):
            if proc is not None and proc.returncode != 0:
                try:
                    os.remove("/dev/shm/" + name.format(proc.pid))
                except FileNotFoundError:
                    pass
