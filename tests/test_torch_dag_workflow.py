"""The port's DAGs (`.bind()`, ray_tpu_torch.dag) and durable workflows
(ray_tpu_torch.workflow).

Every case of tests/test_dag_workflow.py on ray_tpu_torch, then parity with
the reference: the same function, actor and diamond DAGs built in both
packages from the same seeded numpy inputs give equal outputs. Last, the
options a remote function or actor class carries reach the node `.bind()`
builds, and a workflow stores them with the step.
"""

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch import workflow
from ray_tpu_torch.dag import InputNode

T = 60.0


@pytest.fixture(scope="module")
def rt():
    runtime = ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield runtime
    ray_tpu_torch.shutdown()


@pytest.fixture
def wf_storage(tmp_path):
    workflow.init(storage=str(tmp_path))
    yield str(tmp_path)


# ------------------------------------------------ tests/test_dag_workflow.py


def test_function_dag(rt):
    @ray_tpu_torch.remote
    def a(x):
        return x + 1

    @ray_tpu_torch.remote
    def b(x, y):
        return x * y

    dag = b.bind(a.bind(2), a.bind(3))
    assert ray_tpu_torch.get(dag.execute(), timeout=T) == 12


def test_dag_with_input_node(rt):
    @ray_tpu_torch.remote
    def double(x):
        return 2 * x

    @ray_tpu_torch.remote
    def add(x, y):
        return x + y

    with InputNode() as inp:
        dag = add.bind(double.bind(inp), inp)
    assert ray_tpu_torch.get(dag.execute(5), timeout=T) == 15
    assert ray_tpu_torch.get(dag.execute(7), timeout=T) == 21


def test_actor_dag(rt):
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self, start):
            self.v = start

        def incr(self, by):
            self.v += by
            return self.v

    node = Counter.bind(10)
    dag = node.incr.bind(5)
    assert ray_tpu_torch.get(dag.execute(), timeout=T) == 15


def test_diamond_dag_shares_upstream(rt):
    @ray_tpu_torch.remote
    def source():
        return 1

    @ray_tpu_torch.remote
    def left(x):
        return x + 10

    @ray_tpu_torch.remote
    def right(x):
        return x + 100

    @ray_tpu_torch.remote
    def join(a, b):
        return a + b

    s = source.bind()
    dag = join.bind(left.bind(s), right.bind(s))
    assert ray_tpu_torch.get(dag.execute(), timeout=T) == 112


def test_workflow_run_and_output(rt, wf_storage):
    @ray_tpu_torch.remote
    def f(x):
        return x * 2

    @ray_tpu_torch.remote
    def g(x):
        return x + 1

    result = workflow.run(g.bind(f.bind(10)), workflow_id="w1")
    assert result == 21
    assert workflow.get_status("w1") == "SUCCESSFUL"
    assert workflow.get_output("w1") == 21
    assert ("w1", "SUCCESSFUL") in workflow.list_all()


def test_workflow_resume_skips_completed_steps(rt, wf_storage, tmp_path):
    marker = tmp_path / "side_effects.txt"

    @ray_tpu_torch.remote
    def step_a():
        with open(marker, "a") as f:
            f.write("a\n")
        return 5

    @ray_tpu_torch.remote
    def flaky(x):
        import os

        if not os.path.exists(str(marker) + ".allow"):
            raise RuntimeError("injected failure")
        return x * 10

    dag = flaky.bind(step_a.bind())
    with pytest.raises(Exception):
        workflow.run(dag, workflow_id="w2")
    assert workflow.get_status("w2") == "RESUMABLE"
    # Heal the failure, resume: step_a must NOT re-execute.
    open(str(marker) + ".allow", "w").close()
    assert workflow.resume("w2") == 50
    assert workflow.get_status("w2") == "SUCCESSFUL"
    assert open(marker).read().count("a") == 1


def test_workflow_run_async(rt, wf_storage):
    @ray_tpu_torch.remote
    def slow():
        import time

        time.sleep(0.2)
        return 42

    fut = workflow.run_async(slow.bind(), workflow_id="w3")
    assert workflow.get_output("w3", timeout_s=10) == 42
    assert fut.result(timeout=T) == 42


def test_workflow_delete(rt, wf_storage):
    @ray_tpu_torch.remote
    def one():
        return 1

    workflow.run(one.bind(), workflow_id="w4")
    workflow.delete("w4")
    assert workflow.get_status("w4") is None


def test_dag_nested_container_args(rt):
    """DAG nodes nested in list/dict args are executed and substituted."""

    @ray_tpu_torch.remote
    def const(x):
        return x

    @ray_tpu_torch.remote
    def combine(parts, named):
        return sum(ray_tpu_torch.get(list(parts), timeout=60)) + ray_tpu_torch.get(
            named["extra"], timeout=60)

    dag = combine.bind([const.bind(1), const.bind(2)], {"extra": const.bind(10)})
    assert ray_tpu_torch.get(dag.execute(), timeout=T) == 13


# ------------------------------------------------------ parity and options


def _dags(pkg, InputNodeCls):
    """A function DAG, an actor DAG and a diamond over an InputNode, built
    from `pkg`'s remote decorators; numpy in, numpy out."""

    @pkg.remote
    def project(x, w):
        return x @ w

    @pkg.remote
    def mix(a, b):
        return np.tanh(a) * b + 0.5 * a

    @pkg.remote
    class Accumulator:
        def __init__(self, start):
            self.total = np.array(start, dtype=np.float64)

        def add(self, x):
            self.total = self.total + x.sum(axis=0)
            return self.total.copy()

    @pkg.remote
    def left(x):
        return np.cumsum(x, axis=1)

    @pkg.remote
    def right(x):
        return x[::-1] * 3.0

    @pkg.remote
    def join(a, b):
        return a - b

    rng = np.random.RandomState(0)
    x, y, w = rng.randn(4, 6), rng.randn(4, 6), rng.randn(6, 6)
    function_dag = mix.bind(project.bind(x, w), project.bind(y, w))
    acc = Accumulator.bind(rng.randn(6))
    actor_dag = acc.add.bind(project.bind(x, w))
    with InputNodeCls() as inp:
        diamond = join.bind(left.bind(inp), right.bind(inp))
    return function_dag, actor_dag, diamond, rng.randn(5, 3)


def test_dags_match_the_reference(rt):
    """The same three DAGs on both packages: equal outputs, bit for bit
    (both run the same numpy on the same seeded inputs)."""
    from ray_tpu.dag import InputNode as RefInputNode

    ray_tpu.init(num_cpus=4)
    try:
        f, a, d, inp = _dags(ray_tpu, RefInputNode)
        want = [ray_tpu.get(f.execute(), timeout=T), ray_tpu.get(a.execute(), timeout=T),
                ray_tpu.get(d.execute(inp), timeout=T)]
    finally:
        ray_tpu.shutdown()
    f, a, d, inp = _dags(ray_tpu_torch, InputNode)
    got = [ray_tpu_torch.get(f.execute(), timeout=T), ray_tpu_torch.get(a.execute(), timeout=T),
           ray_tpu_torch.get(d.execute(inp), timeout=T)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_options_carry_through_bind(rt, wf_storage):
    """`.options(...)` before `.bind()` reaches the submission: the task's
    grant, the actor's name; a workflow stores the node with its options
    (what a resume reloads) and runs the step with them."""

    @ray_tpu_torch.remote
    def granted():
        ctx = ray_tpu_torch.get_runtime_context()
        return ctx.get_assigned_resources().get("CPU")

    @ray_tpu_torch.remote
    class Named:
        def hello(self):
            return "hi"

    assert ray_tpu_torch.get(granted.bind().execute(), timeout=T) == 1.0
    node = granted.options(num_cpus=3).bind()
    assert node._remote_fn._options["num_cpus"] == 3
    assert ray_tpu_torch.get(node.execute(), timeout=T) == 3.0
    handle = Named.options(name="dag_named").bind().execute()
    assert ray_tpu_torch.get(handle.hello.remote(), timeout=T) == "hi"
    assert ray_tpu_torch.get(
        ray_tpu_torch.get_actor("dag_named").hello.remote(), timeout=T) == "hi"
    ray_tpu_torch.kill(handle)
    assert workflow.run(granted.options(num_cpus=2).bind(), workflow_id="wopt") == 2.0
    assert workflow.get_output("wopt") == 2.0
    from ray_tpu_torch.workflow.storage import WorkflowStorage

    stored = WorkflowStorage("wopt").load_dag()
    assert stored._remote_fn._options["num_cpus"] == 2
