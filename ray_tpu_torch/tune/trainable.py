"""Trainable protocol: class API + function-API wrapper.

Reference: tune/trainable/trainable.py (class API; train :350) and
tune/trainable/function_trainable.py (:287,:576 wrap_function) — the function
API runs the user function on a runner thread and turns each `session.report`
into one `step()` result via the air session's 1-deep rendezvous queue
(train/_internal/session.py semantics, see ray_tpu_torch/air/session.py).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Callable, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.session import TrainContext, _Session, _set_session

logger = logging.getLogger(__name__)

DONE = "done"
TRAINING_ITERATION = "training_iteration"
# How long cleanup() waits for a stopped loop to reach its next report (a
# trainer-backed trial finishes its step and ends its worker group).
STOP_TIMEOUT_S = 120.0


class Trainable:
    """Class API. Subclasses implement setup/step/save_checkpoint/load_checkpoint."""

    def __init__(self, config: Optional[dict] = None):
        self.config = config or {}
        self._iteration = 0
        # Monotonic: time_total_s is a duration fed to schedulers/stoppers.
        self._start = time.monotonic()
        self.setup(self.config)

    # -- overridable -----------------------------------------------------
    def setup(self, config: dict) -> None:
        pass

    def step(self) -> dict:
        raise NotImplementedError

    def save_checkpoint(self) -> Optional[dict]:
        return None

    def load_checkpoint(self, state: Optional[dict]) -> None:
        pass

    def cleanup(self) -> None:
        pass

    def reset_config(self, new_config: dict) -> bool:
        """Return True if the trainable can hot-swap configs (actor reuse)."""
        return False

    # -- controller-facing protocol (actor methods) ----------------------
    def train(self) -> dict:
        result = self.step()
        if not isinstance(result, dict):
            raise ValueError(f"step() must return a dict, got {type(result)}")
        self._iteration += 1
        result.setdefault(DONE, False)
        result[TRAINING_ITERATION] = self._iteration
        result.setdefault("time_total_s", time.monotonic() - self._start)
        result.setdefault("trial_id", getattr(self, "trial_id", None))
        return result

    def save(self) -> dict:
        return {
            "trainable_state": {"iteration": self._iteration},
            "user_state": self.save_checkpoint(),
        }

    def restore(self, state: dict) -> None:
        self._iteration = state["trainable_state"]["iteration"]
        self.load_checkpoint(state["user_state"])

    def reset(self, new_config: dict) -> bool:
        ok = self.reset_config(new_config)
        if ok:
            self.config = new_config
            self._iteration = 0
        return ok

    def stop(self) -> None:
        self.cleanup()


class FunctionTrainable(Trainable):
    """Wraps `def train_fn(config)` into the Trainable protocol."""

    _train_fn: Callable = None  # set by wrap_function subclass

    def setup(self, config: dict) -> None:
        self._session = _Session(
            TrainContext(trial_id=getattr(self, "trial_id", "")),
            checkpoint=getattr(self, "_restore_checkpoint", None),
        )
        self._error: list = []
        self._thread: Optional[threading.Thread] = None
        self._last_checkpoint: Optional[Checkpoint] = None

    def _runner(self) -> None:
        _set_session(self._session)
        try:
            self._train_fn(self.config)
        except StopIteration:
            pass
        except BaseException as e:  # surfaced on the next step()
            self._error.append(e)
        finally:
            self._session.finish()
            _set_session(None)

    def step(self) -> dict:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._runner, daemon=True,
                name=f"tune-trial-{getattr(self, 'trial_id', '')}",
            )
            self._thread.start()
        item = self._session.result_queue.get()
        if item is _Session.FINISHED:
            if self._error:
                raise self._error[0]
            # Final sentinel repeats the last reported metrics (reference:
            # function_trainable's last result carries done=True).
            return {**getattr(self, "_last_metrics", {}), DONE: True}
        if item["checkpoint"] is not None:
            self._last_checkpoint = item["checkpoint"]
        metrics = item["metrics"]
        metrics.setdefault(DONE, False)
        self._last_metrics = dict(metrics)
        return metrics

    def save_checkpoint(self) -> Optional[dict]:
        ckpt = self._last_checkpoint
        return None if ckpt is None else ckpt.to_dict()

    def load_checkpoint(self, state: Optional[dict]) -> None:
        if state is not None:
            self._restore_checkpoint = Checkpoint.from_dict(state)
            # Session is rebuilt on next setup; for in-place restore, expose it.
            if hasattr(self, "_session"):
                self._session.loaded_checkpoint = self._restore_checkpoint

    def cleanup(self) -> None:
        """Stop the runner thread and wait until it has ended. After the stop
        event, every report() raises StopIteration, so draining the 1-deep
        rendezvous frees a report() parked in put(), and then the runner's
        final finish(): the loop returns, and a trainer-backed trial's fit()
        takes its worker group down on the way out. The wait is a polled
        condition (the thread ended) under a deadline, not a fixed
        join: a function loop ends at its next report (STOP_TIMEOUT_S)."""
        thread = self._thread
        if thread is None or not thread.is_alive():
            return
        self._session.stop_event.set()
        deadline = time.monotonic() + STOP_TIMEOUT_S
        while thread.is_alive() and time.monotonic() < deadline:
            try:
                self._session.result_queue.get(timeout=0.01)
            except queue.Empty:
                pass
            thread.join(timeout=0.01)
        if thread.is_alive():
            logger.warning(
                "trial %s: the runner thread did not end within %.0fs of its stop",
                getattr(self, "trial_id", ""), STOP_TIMEOUT_S,
            )


def wrap_function(train_fn: Callable) -> type:
    """Build a FunctionTrainable subclass around `train_fn(config)`."""

    class _Wrapped(FunctionTrainable):
        _train_fn = staticmethod(train_fn)

    _Wrapped.__name__ = getattr(train_fn, "__name__", "function_trainable")
    return _Wrapped


def with_parameters(fn_or_cls: Any, **kwargs) -> Any:
    """Bind large objects by closure (reference: tune/utils/trainable.py
    with_parameters; the reference ray.put's them — in-process runtime makes
    plain closure capture equivalent)."""
    if isinstance(fn_or_cls, type):
        class _Bound(fn_or_cls):  # type: ignore[misc]
            def setup(self, config):
                super().setup(config, **kwargs)

        _Bound.__name__ = fn_or_cls.__name__
        return _Bound

    def bound(config):
        return fn_or_cls(config, **kwargs)

    bound.__name__ = getattr(fn_or_cls, "__name__", "bound_trainable")
    return bound
