"""Deterministic fault injection for chaos testing.

Hot paths call ``maybe_fail(site, detail)`` at named injection points — the
engine step (`llm.step`, `llm.prefill`, `engine.prefill_chunk`,
`llm.decode.seq`). With no faults configured the call is one truthiness
check, so the sites are safe to leave in production code.

Faults are configured either programmatically::

    from ray_tpu_torch._private import fault_injection as fi
    fi.inject("llm.prefill", match=request_id,
              exc_factory=lambda: RuntimeError("boom"))
    ...
    fi.clear()

or through the environment (picked up at import)::

    RAY_TPU_TORCH_FAULT_INJECTION="site=llm.step,nth=2,times=3"

Each spec is deterministic: triggering is driven by per-spec hit counters
(`nth`/`every`) or a seeded RNG (`probability`, `seed`), never by wall-clock
time, so a failing chaos run replays exactly.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Callable, List, Optional

ENV_VAR = "RAY_TPU_TORCH_FAULT_INJECTION"


class InjectedFault(RuntimeError):
    """Default exception raised at an injection point."""


@dataclasses.dataclass(eq=False)  # identity eq: remove() must not match a twin
class FaultSpec:
    """One configured fault.

    Triggering (checked per matching hit, in order):
      * ``probability`` — seeded coin flip per hit (deterministic sequence);
      * ``every`` — fire on every k-th matching hit;
      * otherwise — fire once the hit count reaches ``nth`` (1-based).
    ``times`` bounds how many times the spec fires in total (None = no bound).
    """

    site: str
    action: str = "raise"  # "raise" | "delay"
    nth: int = 1
    times: Optional[int] = 1
    every: Optional[int] = None
    probability: Optional[float] = None
    seed: int = 0
    match: str = ""  # substring filter on the site's detail string
    delay_s: float = 0.0
    message: str = ""
    exc_factory: Optional[Callable[[], BaseException]] = None
    # Runtime state (not configuration).
    hits: int = 0
    fires: int = 0

    def __post_init__(self):
        if self.action not in ("raise", "delay"):
            raise ValueError(f"action must be 'raise' or 'delay', got {self.action!r}")
        if self.nth < 1:
            raise ValueError("nth is 1-based and must be >= 1")
        self._rng = random.Random(self.seed)

    def _should_fire(self) -> bool:
        if self.times is not None and self.fires >= self.times:
            return False
        if self.probability is not None:
            return self._rng.random() < self.probability
        if self.every is not None:
            return self.hits % self.every == 0
        return self.hits >= self.nth

    def _build_exception(self) -> BaseException:
        if self.exc_factory is not None:
            return self.exc_factory()
        return InjectedFault(
            self.message or f"injected fault at {self.site!r} (hit {self.hits})"
        )


_LOCK = threading.Lock()
_SPECS: List[FaultSpec] = []


def inject(site: str, **kwargs) -> FaultSpec:
    """Register a fault at `site`; returns the spec (its `hits`/`fires`
    counters are live, so tests can assert the fault actually triggered)."""
    spec = FaultSpec(site=site, **kwargs)
    with _LOCK:
        _SPECS.append(spec)
    return spec


def remove(spec: FaultSpec) -> None:
    with _LOCK:
        if spec in _SPECS:
            _SPECS.remove(spec)


def clear() -> None:
    with _LOCK:
        _SPECS.clear()


def specs() -> List[FaultSpec]:
    with _LOCK:
        return list(_SPECS)


class injected:
    """Context manager: `with injected("llm.step", times=2) as spec: ...`
    removes the spec on exit even when the body raises."""

    def __init__(self, site: str, **kwargs):
        self._spec = FaultSpec(site=site, **kwargs)

    def __enter__(self) -> FaultSpec:
        with _LOCK:
            _SPECS.append(self._spec)
        return self._spec

    def __exit__(self, *exc_info):
        remove(self._spec)
        return False


def maybe_fail(site: str, detail: str = "") -> None:
    """Injection point. No-op (one truthiness check) unless a registered
    spec matches `site` (and its `match` substring appears in `detail`)."""
    if not _SPECS:
        return
    to_fire = None
    with _LOCK:
        for spec in _SPECS:
            if spec.site != site:
                continue
            if spec.match and spec.match not in detail:
                continue
            spec.hits += 1
            if spec._should_fire():
                spec.fires += 1
                to_fire = spec
                break
    if to_fire is None:
        return
    if to_fire.action == "delay":
        time.sleep(to_fire.delay_s)
        return
    raise to_fire._build_exception()


def _resolve_exc(name: str) -> Callable[[], BaseException]:
    """Map an env-provided exception name to a zero-arg factory. Looked up
    in ray_tpu_torch.exceptions first, then builtins."""
    import builtins

    from ray_tpu_torch import exceptions as _exceptions

    cls = getattr(_exceptions, name, None) or getattr(builtins, name, None)
    if cls is None or not (isinstance(cls, type) and issubclass(cls, BaseException)):
        raise ValueError(f"unknown exception type {name!r} in {ENV_VAR}")
    return lambda: cls("injected fault")


def configure_from_env(value: Optional[str] = None) -> List[FaultSpec]:
    """Parse `RAY_TPU_FAULT_INJECTION` (or an explicit string) and register
    the specs it describes. Format: semicolon-separated specs of
    comma-separated key=value pairs; `exc=Name` resolves against
    ray_tpu_torch.exceptions then builtins."""
    raw = value if value is not None else os.environ.get(ENV_VAR, "")
    registered: List[FaultSpec] = []
    for chunk in raw.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        fields: dict = {}
        for pair in chunk.split(","):
            key, _, val = pair.partition("=")
            key = key.strip()
            val = val.strip()
            if key in ("nth", "times", "every", "seed"):
                fields[key] = int(val)
            elif key in ("probability", "delay_s"):
                fields[key] = float(val)
            elif key == "exc":
                fields["exc_factory"] = _resolve_exc(val)
            else:
                fields[key] = val
        site = fields.pop("site", None)
        if not site:
            raise ValueError(f"{ENV_VAR} spec missing site=: {chunk!r}")
        registered.append(inject(site, **fields))
    return registered


if os.environ.get(ENV_VAR):
    configure_from_env()
