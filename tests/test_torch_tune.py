"""ray_tpu_torch.tune against the reference's Tune (ray_tpu.tune).

Every module of the port's Tune is held to its reference on the same seeded
inputs: the domains' samples and perturbations, the variant generator and
the searchers (basic, random, concurrency-limited, TPE, BOHB), each
scheduler's decisions (and PBT's exploits) on the same synthetic result
streams, DistributeResources with "GPU" where the reference has "TPU", and
Tuner / tune.run end to end with function and class trainables. The port's
own changes are tested last: its default experiment root, the writer-own
temporary state file, and a stopped function trial that ends its thread
at once (the reference waits a fixed 2 s and can leave it parked).
"""

import os
import random
import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import tune as ref_tune
from ray_tpu.air import session as ref_session
from ray_tpu.air.checkpoint import Checkpoint as RefCheckpoint
from ray_tpu.air.config import CheckpointConfig as RefCheckpointConfig
from ray_tpu.air.config import RunConfig as RefRunConfig
from ray_tpu.tune import schedulers as ref_schedulers
from ray_tpu.tune.experiment.trial import Trial as RefTrial
from ray_tpu.tune.search import bohb as ref_bohb
from ray_tpu.tune.search import tpe as ref_tpe
from ray_tpu.tune.search import variant_generator as ref_vg
from ray_tpu_torch import tune as port_tune
from ray_tpu_torch.air import session as port_session
from ray_tpu_torch.air.checkpoint import Checkpoint as PortCheckpoint
from ray_tpu_torch.air.config import CheckpointConfig as PortCheckpointConfig
from ray_tpu_torch.air.config import RunConfig as PortRunConfig
from ray_tpu_torch.tune import schedulers as port_schedulers
from ray_tpu_torch.tune.execution.tune_controller import TuneController
from ray_tpu_torch.tune.experiment.trial import Trial as PortTrial
from ray_tpu_torch.tune.search import bohb as port_bohb
from ray_tpu_torch.tune.search import tpe as port_tpe
from ray_tpu_torch.tune.search import variant_generator as port_vg

REF = dict(tune=ref_tune, sched=ref_schedulers, Trial=RefTrial, tpe=ref_tpe,
           bohb=ref_bohb, vg=ref_vg, session=ref_session, RunConfig=RefRunConfig,
           Checkpoint=RefCheckpoint, CheckpointConfig=RefCheckpointConfig)
PORT = dict(tune=port_tune, sched=port_schedulers, Trial=PortTrial, tpe=port_tpe,
            bohb=port_bohb, vg=port_vg, session=port_session, RunConfig=PortRunConfig,
            Checkpoint=PortCheckpoint, CheckpointConfig=PortCheckpointConfig)
SEEDS = (0, 1, 2)


@pytest.fixture
def runtimes():
    """Both runtimes, 4 CPUs each (they can be up in one process)."""
    ray_tpu.init(num_cpus=4)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _space(tune) -> dict:
    """Every domain kind, nested, beside a grid and a plain value."""
    return {
        "lr": tune.loguniform(1e-5, 1e-1),
        "momentum": tune.uniform(0.5, 0.99),
        "layers": tune.randint(1, 6),
        "act": tune.choice(["relu", "gelu", "tanh"]),
        "opt": {"beta": tune.quniform(0.1, 0.9, 0.05), "noise": tune.randn(0.0, 2.0),
                "q": tune.qrandn(0.0, 1.0, 0.25)},
        "width": tune.grid_search([32, 64]),
        "fixed": 7,
    }


# -- domains, variants, searchers --------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_domain_samples_and_perturbations_match(seed):
    """Each domain draws and perturbs the same values from the same
    random.Random stream."""
    for key in ("lr", "momentum", "layers", "act"):
        got_domain, want_domain = _space(port_tune)[key], _space(ref_tune)[key]
        rng_got, rng_want = random.Random(seed), random.Random(seed)
        got = [got_domain.sample(rng_got) for _ in range(16)]
        want = [want_domain.sample(rng_want) for _ in range(16)]
        assert got == want, key
        got = [got_domain.perturb(v, rng_got) for v in got]
        want = [want_domain.perturb(v, rng_want) for v in want]
        assert got == want, key
    for key in ("beta", "noise", "q"):
        rng_got, rng_want = random.Random(seed), random.Random(seed)
        got = [_space(port_tune)["opt"][key].sample(rng_got) for _ in range(16)]
        want = [_space(ref_tune)["opt"][key].sample(rng_want) for _ in range(16)]
        assert got == want, key
    assert port_tune.grid_search([1, 2]) == ref_tune.grid_search([1, 2])


@pytest.mark.parametrize("seed", SEEDS)
def test_generate_variants_match(seed):
    """Grid times samples, in the same order, with the same draws."""
    got = list(port_vg.generate_variants(_space(port_tune), num_samples=3, seed=seed))
    want = list(ref_vg.generate_variants(_space(ref_tune), num_samples=3, seed=seed))
    assert len(got) == 6 and got == want
    assert port_vg.count_variants(_space(port_tune), 3) == ref_vg.count_variants(
        _space(ref_tune), 3) == 6


@pytest.mark.parametrize("seed", SEEDS)
def test_searchers_suggest_the_same_stream(seed):
    """BasicVariantGenerator, RandomSearch and a ConcurrencyLimiter over
    RandomSearch suggest the same configs in the same order."""
    def run(tune):
        out = []
        basic = tune.BasicVariantGenerator(_space(tune), num_samples=2, seed=seed)
        out.append([basic.suggest(f"t{i}") for i in range(5)])  # the last is None
        out.append(basic.total_samples)
        rnd = tune.RandomSearch(_space(tune), seed=seed)
        out.append([rnd.suggest(f"r{i}") for i in range(4)])
        lim = tune.ConcurrencyLimiter(tune.RandomSearch(_space(tune), seed=seed),
                                      max_concurrent=2)
        stream = [lim.suggest("a"), lim.suggest("b"), lim.suggest("c")]
        lim.on_trial_complete("a", {"score": 1.0})
        stream.append(lim.suggest("d"))
        out.append((stream, lim.is_saturated()))
        return out

    got, want = run(port_tune), run(ref_tune)
    assert got[0][-1] is None and got[2][0] is not None
    assert got == want


def _objective(config) -> float:
    return (-((config["x"] - 0.7) ** 2) - (config["lr"] - 0.01) ** 2 * 10
            + (config["k"] == 3) * 0.1 + (config["c"] == "b") * 0.05)


def _tpe_space(tune) -> dict:
    return {"x": tune.uniform(-2, 2), "lr": tune.loguniform(1e-4, 1.0),
            "k": tune.randint(1, 8), "big": tune.randint(0, 1000),
            "c": tune.choice(["a", "b", "c"]), "q": tune.quniform(0, 1, 0.1),
            "n": tune.qrandn(0.0, 1.0, 0.5), "fixed": 3}


@pytest.mark.parametrize("seed", SEEDS)
def test_tpe_suggestions_match(seed):
    """TPESearch past its random start-up: the same suggestions for the same
    completed history, under one seed (mode min, so the sign flips too)."""
    def run(mod):
        s = mod["tpe"].TPESearch(_tpe_space(mod["tune"]), metric="loss", mode="min",
                                 n_startup_trials=5, n_candidates=12, seed=seed)
        out = []
        for i in range(14):
            config = s.suggest(f"t{i}")
            out.append(config)
            s.on_trial_complete(f"t{i}", {"loss": -_objective(config)})
        return out

    got, want = run(PORT), run(REF)
    assert got == want


@pytest.mark.parametrize("seed", SEEDS)
def test_bohb_suggestions_match(seed):
    """TuneBOHB fed rung results at budgets 1, 3 and 9: the same per-budget
    models and suggestions under one seed."""
    def run(mod):
        s = mod["bohb"].TuneBOHB(_tpe_space(mod["tune"]), metric="score", mode="max",
                                 max_t=9, reduction_factor=3, n_candidates=12, seed=seed)
        out = []
        for i in range(16):
            config = s.suggest(f"t{i}")
            out.append(config)
            for budget in (1, 3, 9)[: 1 + i % 3]:
                s.on_trial_result(f"t{i}", {"score": _objective(config) + budget * 0.01,
                                            "training_iteration": budget})
            s.on_trial_complete(f"t{i}")
        out.append(s._model_budget())
        return out

    got, want = run(PORT), run(REF)
    assert got[-1] is not None and got == want


# -- schedulers on synthetic result streams ----------------------------------


def _schedulers(mod) -> dict:
    sched, tune = mod["sched"], mod["tune"]
    mutations = {"lr": tune.loguniform(1e-4, 1e-1), "act": ["relu", "gelu", "tanh"]}

    def grow(controller, trial, result, scheduler):
        if result["training_iteration"] == 3:
            return {**trial.resources, "CPU": 2.0}
        return None

    return {
        "fifo": lambda s: sched.FIFOScheduler(),
        "asha": lambda s: sched.AsyncHyperBandScheduler(max_t=9, grace_period=1,
                                                        reduction_factor=2),
        "hyperband": lambda s: sched.HyperBandScheduler(max_t=9, reduction_factor=3,
                                                        brackets=2),
        "hyperband_bohb": lambda s: sched.HyperBandForBOHB(max_t=9, reduction_factor=3,
                                                           brackets=2),
        "median": lambda s: sched.MedianStoppingRule(grace_period=2,
                                                     min_samples_required=3),
        "pbt": lambda s: sched.PopulationBasedTraining(
            perturbation_interval=2, hyperparam_mutations=mutations,
            quantile_fraction=0.34, resample_probability=0.3, seed=s),
        "pb2": lambda s: sched.PB2(perturbation_interval=2,
                                   hyperparam_mutations={"lr": tune.loguniform(1e-4, 1e-1)},
                                   quantile_fraction=0.34, seed=s),
        "resource_changing": lambda s: sched.ResourceChangingScheduler(
            base_scheduler=sched.AsyncHyperBandScheduler(max_t=9, reduction_factor=2),
            resources_allocation_function=grow),
    }


def _drive(mod, name: str, seed: int, n_trials: int = 6, max_t: int = 9) -> list:
    """A minimal controller over synthetic results: trials report in a
    seeded random order, scores follow each trial's (possibly exploited)
    config plus seeded noise; STOP and max_t end a trial, PAUSE parks it
    until the scheduler lets it resume, PBT's exploits replace its config.
    Returns every decision with what it acted on."""
    Trial, TS = mod["Trial"], mod["sched"].TrialScheduler
    rng = random.Random(seed)
    sched = _schedulers(mod)[name](seed)
    sched.set_search_properties("score", "max")
    trials = [Trial("t", {"lr": 10 ** rng.uniform(-4, -1), "act": rng.choice(["relu", "gelu"])},
                    trial_id=f"t{i}") for i in range(n_trials)]
    for t in trials:
        sched.on_trial_add(t)
        t.set_status(Trial.RUNNING)
    log = []
    while True:
        for t in trials:
            if t.status == Trial.PAUSED and sched.may_resume(t):
                t.set_status(Trial.RUNNING)
        live = [t for t in trials if t.status == Trial.RUNNING]
        if not live:
            break
        t = rng.choice(live)
        t.iteration += 1
        score = -abs(t.config["lr"] - 0.01) * 100 + (t.config["act"] == "gelu") + rng.gauss(0, 0.3)
        result = {"score": score, "training_iteration": t.iteration}
        decision = sched.on_trial_result(t, result)
        exploit = None
        pending = getattr(sched, "pending_exploits", None)
        if pending and t.trial_id in pending:
            src, new_config = pending.pop(t.trial_id)
            exploit = (src.trial_id, dict(new_config))
            t.config = new_config
        resize = dict(getattr(sched, "pending_resources", {}).pop(t.trial_id, {}))
        log.append((t.trial_id, t.iteration, decision, exploit, resize))
        if decision == TS.STOP or t.iteration >= max_t:
            t.set_status(Trial.TERMINATED)
            sched.on_trial_complete(t, result)
        elif decision == TS.PAUSE:
            t.set_status(Trial.PAUSED)
            sched.on_trial_remove(t)
    return log


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", list(_schedulers(PORT)))
def test_scheduler_decisions_match(name, seed):
    """The same synthetic stream through both packages' scheduler: the same
    decision for every result, the same exploits (source and explored
    config) and resizes."""
    got, want = _drive(PORT, name, seed), _drive(REF, name, seed)
    assert got == want
    decisions = {d for _, _, d, _, _ in got}
    if name in ("asha", "hyperband", "hyperband_bohb", "median"):
        assert "STOP" in decisions, decisions  # the stream exercises stopping
    if name in ("pbt", "pb2"):
        assert any(e for _, _, _, e, _ in got)


def test_distribute_resources_grows_gpu_like_the_reference_tpu():
    """DistributeResources: the port grows "GPU" (the resource its init()
    advertises) as the reference grows "TPU", from the cluster totals."""
    class _Ctl:
        _live = {"a": 1, "b": 1, "c": 1}

    class _Trial:
        def __init__(self, resources):
            self.resources = resources

    ray_tpu.init(num_cpus=12, num_tpus=6)
    ray_tpu_torch.init(num_cpus=12, num_gpus=6)
    try:
        for base in ({"CPU": 1.0}, {"CPU": 1.0, "ACC": 0.5}, {"CPU": 5.0, "ACC": 1.0}):
            ref_base = {("TPU" if k == "ACC" else k): v for k, v in base.items()}
            port_base = {("GPU" if k == "ACC" else k): v for k, v in base.items()}
            want = ref_schedulers.DistributeResources(ref_base)(
                _Ctl(), _Trial(dict(ref_base)), {}, None)
            got = port_schedulers.DistributeResources(port_base)(
                _Ctl(), _Trial(dict(port_base)), {}, None)
            assert got == {("GPU" if k == "TPU" else k): v for k, v in want.items()}
        assert got == {"CPU": 5.0, "GPU": 2.0}
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()


# -- Tuner and tune.run end to end -------------------------------------------


def _strip(result: dict) -> dict:
    """A result without its clocks and ids (they differ run to run)."""
    return {k: v for k, v in result.items() if k not in ("time_total_s", "trial_id")}


def _trials(controller) -> list:
    return [(t.trial_id, t.status, t.config, [_strip(r) for r in t.results])
            for t in controller.trials]


def _make_loop(mod):
    session = mod["session"]

    def loop(config):
        for i in range(6):
            session.report({"loss": (config["x"] - 3.0) ** 2 + 1.0 / (i + 1),
                            "step": i})

    return loop


@pytest.mark.parametrize("seed", (0, 1))
def test_tuner_function_trainable_asha_matches(runtimes, tmp_path, seed):
    """Tuner over a function trainable, sampled x, ASHA, one trial at a time
    (so the result order, and with it every decision, is fixed): the same
    trials, configs, statuses and results, the same best result."""
    def run(mod, sub):
        tune = mod["tune"]
        tuner = tune.Tuner(
            _make_loop(mod),
            param_space={"x": tune.uniform(0.0, 6.0), "tag": tune.choice(["a", "b"])},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", num_samples=6, seed=seed,
                max_concurrent_trials=1,
                scheduler=mod["sched"].AsyncHyperBandScheduler(
                    max_t=6, grace_period=1, reduction_factor=2)),
            run_config=mod["RunConfig"](name="asha", storage_path=str(tmp_path / sub)),
        )
        grid = tuner.fit()
        best = grid.get_best_result()
        return _trials(tuner._controller), best.config, best.metrics["loss"]

    got, want = run(PORT, "port"), run(REF, "ref")
    assert got == want
    assert any(len(results) < 6 for _, _, _, results in got[0])  # ASHA stopped one
    assert os.path.exists(tmp_path / "port" / "asha" / "experiment_state.json")


class _Counter(port_tune.Trainable):
    def setup(self, config):
        self.value = config["start"]

    def step(self):
        self.value += self.config["inc"]
        return {"value": self.value}

    def save_checkpoint(self):
        return {"value": self.value}

    def load_checkpoint(self, state):
        self.value = state["value"]


class _RefCounter(ref_tune.Trainable):
    setup = _Counter.setup
    step = _Counter.step
    save_checkpoint = _Counter.save_checkpoint
    load_checkpoint = _Counter.load_checkpoint


def test_run_class_trainable_stop_criteria_matches(runtimes, tmp_path):
    """tune.run over a class trainable with a grid, a dict stopper and
    checkpoints at the end: the same results and final checkpoints."""
    def run(mod, cls, sub):
        tune = mod["tune"]
        grid = tune.run(
            cls, config={"start": tune.grid_search([0, 10]), "inc": tune.grid_search([1, 3])},
            metric="value", mode="max", stop={"value": 18}, checkpoint_at_end=True,
            experiment_dir=str(tmp_path / sub),
        )
        return ([(_strip(r.metrics), r.config, r.checkpoint.to_dict()) for r in grid],
                grid.get_best_result().metrics["value"])

    got, want = run(PORT, _Counter, "port"), run(REF, _RefCounter, "ref")
    assert got == want and got[1] == 19


def test_tuner_restore_reruns_unfinished_trials(runtimes, tmp_path):
    """Tuner.restore re-seeds the trials that did not finish, from their
    pickled checkpoints, as the reference does: the same resumed results."""
    def run(mod, sub):
        tune, session, from_ckpt = mod["tune"], mod["session"], mod["Checkpoint"]

        def loop(config):
            ckpt = session.get_checkpoint()
            start = ckpt.to_dict()["i"] + 1 if ckpt else 0
            for i in range(start, 4):
                if config["x"] == 2 and i == 2 and ckpt is None:
                    raise RuntimeError("fails once, at step 2")
                session.report({"i": i, "x": config["x"]},
                               checkpoint=from_ckpt.from_dict({"i": i}))

        path = tmp_path / sub
        rc = mod["RunConfig"](name="exp", storage_path=str(path),
                              checkpoint_config=mod["CheckpointConfig"](checkpoint_frequency=1))
        tuner = tune.Tuner(loop, param_space={"x": tune.grid_search([1, 2])},
                           tune_config=tune.TuneConfig(metric="i", mode="max",
                                                       max_concurrent_trials=1),
                           run_config=rc)
        first = sorted((r.config["x"], r.metrics.get("i"), bool(r.error)) for r in tuner.fit())
        restored = tune.Tuner.restore(str(path / "exp"), loop)
        second = [(r.config["x"], [m["i"] for m in r.metrics_history])
                  for r in restored.fit()]
        return first, second

    got, want = run(PORT, "port"), run(REF, "ref")
    assert got == want
    # Resumed after its last checkpoint (step 1); the loop's end repeats the
    # last metrics with done=True, as the reference's FunctionTrainable does.
    assert got[1] == [(2, [2, 3, 3])]


# -- the port's own changes --------------------------------------------------


def test_default_experiment_root_is_the_ports_own(runtimes, tmp_path, monkeypatch):
    """Without a storage path the controller writes under
    ~/ray_tpu_torch_results/exp_<seconds>, and a named run under
    ~/ray_tpu_torch_results/<name>: never under the reference's root."""
    monkeypatch.setenv("HOME", str(tmp_path))
    assert PortRunConfig(name="n").resolved_storage_path() == os.path.join(
        str(tmp_path), "ray_tpu_torch_results", "n")
    controller = TuneController(port_tune.wrap_function(_make_loop(PORT)),
                                param_space={"x": 1.0}, metric="loss", mode="min")
    root = os.path.dirname(controller._experiment_dir)
    assert root == os.path.join(str(tmp_path), "ray_tpu_torch_results")
    assert os.path.basename(controller._experiment_dir).startswith("exp_")
    controller.run()
    assert os.path.exists(os.path.join(controller._experiment_dir, "experiment_state.json"))
    assert not os.path.exists(os.path.join(str(tmp_path), "ray_tpu_results"))


def test_two_controllers_share_a_directory_without_clobbering(runtimes, tmp_path):
    """Two controllers on one experiment directory (two runs started within
    one second on the default root) save their state concurrently: each
    writes through a temporary file of its own, so no os.replace fails."""
    a, b = (TuneController(port_tune.wrap_function(_make_loop(PORT)), param_space={"x": x},
                           experiment_dir=str(tmp_path)) for x in (1.0, 2.0))
    errors = []

    def save(controller):
        try:
            for _ in range(200):
                controller._save_experiment_state()
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=save, args=(c,)) for c in (a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def _tune_threads() -> list:
    return [t for t in threading.enumerate()
            if t.name.startswith("tune-trial-") and t.is_alive()]


def _wait_for(cond, timeout_s: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def test_stopped_function_trial_ends_its_thread(runtimes, tmp_path):
    """A trial stopped before its loop ends (ASHA, then max_t below the
    loop's length) leaves no runner thread. The loop keeps reporting past
    the stop; cleanup drains the rendezvous until the thread has ended,
    where the reference waits 2 s and leaves it parked in finish()."""
    stopped_at = {}

    def loop(config):
        for i in range(50):
            try:
                port_session.report({"score": config["x"] * (i + 1)})
            except StopIteration:
                stopped_at[config["x"]] = i
                raise

    tuner = port_tune.Tuner(
        loop, param_space={"x": port_tune.grid_search([1.0, 2.0, 3.0, 4.0])},
        tune_config=port_tune.TuneConfig(
            metric="score", mode="max", max_concurrent_trials=2,
            scheduler=port_schedulers.AsyncHyperBandScheduler(
                max_t=4, grace_period=1, reduction_factor=2)),
        run_config=PortRunConfig(name="stop", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid) == 4 and grid.num_errors == 0
    assert all(r.metrics["training_iteration"] <= 4 for r in grid)
    assert _wait_for(lambda: not _tune_threads()), _tune_threads()
    assert sorted(stopped_at) == [1.0, 2.0, 3.0, 4.0]  # every loop saw its stop
