"""The port's state API (`ray_tpu_torch.util.state`) against the reference's.

One seeded program of tasks (some failing), actors (one named, one killed),
objects and placement groups (one placed, one left pending) runs on both
packages, each in a fresh process (a test process may hold threads of an
earlier test's runtime that would add rows of their own); every `list_*`
and `summarize_*` answer is compared row for row, with IDs masked to their
presence and task times dropped (rows are sorted first: concurrent tasks
finish in either order on either side).
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.util import state as jax_state
from ray_tpu_torch.util import state as torch_state

PACKAGES = {"ray_tpu": (ray_tpu, jax_state), "ray_tpu_torch": (ray_tpu_torch, torch_state)}
ID_KEYS = ("task_id", "job_id", "actor_id", "node_id", "object_id",
           "placement_group_id")
HEX_ID = re.compile(r"[0-9a-f]{16,}")  # a placement group's id in resource names


def _mask(value):
    """IDs become their presence (or `<id>` inside a name), the package's
    name in a message the reference's; lists of rows become a sorted list."""
    if isinstance(value, dict):
        return {_mask(k): (v is not None and v != "") if k in ID_KEYS else _mask(v)
                for k, v in value.items() if k != "state_times"}
    if isinstance(value, list):
        rows = [_mask(v) for v in value]
        return sorted(rows, key=repr) if all(isinstance(r, dict) for r in rows) else rows
    if isinstance(value, str):
        return HEX_ID.sub("<id>", value.replace("ray_tpu_torch", "ray_tpu"))
    return value


def _program(rt, seed: int):
    rng = np.random.RandomState(seed)
    values = rng.randint(0, 100, size=6).tolist()

    @rt.remote
    def square(x):
        return x * x

    @rt.remote
    def broken(x):
        raise ValueError(f"bad {x}")

    @rt.remote
    class Keeper:
        def __init__(self, start):
            self.total = start

        def add(self, k):
            self.total += k
            return self.total

    squares = rt.get([square.remote(v) for v in values])
    failed = broken.remote(values[0])
    with pytest.raises(ValueError):
        rt.get(failed)
    keeper = Keeper.options(name="keeper").remote(values[1])
    totals = [rt.get(keeper.add.remote(v)) for v in values[:3]]
    doomed = Keeper.remote(0)
    rt.get(doomed.add.remote(1))
    rt.kill(doomed)
    held = [rt.put(np.full(4, v)) for v in values[:2]]
    placed = rt.util.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    assert placed.ready(timeout=30)
    pending = rt.util.placement_group([{"CPU": 64}], strategy="STRICT_PACK")
    time.sleep(0.2)  # the kill and the placements settle in the tables
    return {"squares": squares, "totals": totals, "keep": (keeper, held, failed,
                                                           placed, pending)}


def _answers(state) -> dict:
    return {
        "tasks": state.list_tasks(),
        "tasks_detail": state.list_tasks(detail=True),
        "tasks_failed": state.list_tasks(filters=[("state", "=", "FAILED")]),
        "tasks_not_square": state.list_tasks(filters=[("name", "!=", "square")]),
        "tasks_limit": len(state.list_tasks(limit=3)),
        "actors": state.list_actors(),
        "actors_named": state.list_actors(filters=[("name", "=", "keeper")]),
        "nodes": state.list_nodes(),
        "objects": state.list_objects(),
        "placement_groups": state.list_placement_groups(),
        "summary_tasks": state.summarize_tasks(),
        "summary_actors": state.summarize_actors(),
    }


def in_fresh_process(fn: str, *args):
    """This module's `fn(*args)` in a new interpreter, its JSON result."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import {mod} as m; "
            "print('RESULT ' + json.dumps(getattr(m, sys.argv[2])(*json.loads(sys.argv[3]))))"
            ).format(mod=os.path.splitext(os.path.basename(__file__))[0])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.dirname(here), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-c", code, here, fn, json.dumps(args)],
                          capture_output=True, text=True, timeout=240, env=env)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(lines[-1][len("RESULT "):])


def collect(name: str, seed: int) -> dict:
    """The program on package `name`, every answer masked."""
    rt, state = PACKAGES[name]
    rt.init(num_cpus=4, num_gpus=0)
    try:
        out = _program(rt, seed)
        answers = _answers(state)
        # get_task finds a listed task by its id, on either side.
        some = answers["tasks"][0]
        assert state.get_task(some["task_id"])["name"] == some["name"]
        assert state.get_task("0" * 48) is None
        return {"values": (out["squares"], out["totals"]),
                **{k: _mask(v) for k, v in answers.items()}}
    finally:
        rt.shutdown()


@pytest.mark.parametrize("seed", [0, 1])
def test_state_rows_match_the_reference(seed):
    got = {name: in_fresh_process("collect", name, seed) for name in PACKAGES}
    want, have = got["ray_tpu"], got["ray_tpu_torch"]
    assert have.keys() == want.keys()
    for key in want:
        assert have[key] == want[key], key
    # The program's rows are all there: both tasks kinds, both actors, the
    # held objects, both placement groups (one pending).
    assert have["summary_tasks"]["_program.<locals>.broken:FAILED"] == 1
    assert have["summary_actors"] == {"Keeper:ALIVE": 1, "Keeper:DEAD": 1}
    assert sorted(pg["state"] for pg in have["placement_groups"]) == ["CREATED", "PENDING"]


def test_filter_ops_match_the_reference():
    rows = [{"name": "a", "state": "RUNNING"}, {"name": "b", "state": "FINISHED"},
            {"name": "a", "state": "FINISHED"}]
    from ray_tpu.util.state.api import _apply_filters as jax_filters
    from ray_tpu_torch.util.state.api import _apply_filters as torch_filters

    for filters in ([("name", "=", "a")], [("state", "!=", "FINISHED")],
                    [("name", "=", "a"), ("state", "=", "FINISHED")], None, []):
        assert torch_filters(list(rows), filters) == jax_filters(list(rows), filters)
    for fn in (jax_filters, torch_filters):
        with pytest.raises(ValueError, match="Unsupported filter op"):
            fn(rows, [("name", "~", "a")])
