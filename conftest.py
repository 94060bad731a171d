"""Session set-up that must run once, before any test process starts.

The reference package builds its native store library (`make -C src` into
`src/build/`) on first use. Under pytest-xdist every worker collects every
test file, and `tests/test_native_store.py` asks for the library at import,
so without this hook several workers run that `make` at once; g++ writes
`libtpustore.so` in place, and a worker that loads the half-written file
marks the library failed for the rest of its session. Building it here, in
the controller (or in a plain session) and before any worker exists, leaves
each worker a finished file to load.

A `make` that fails or times out is ignored: the tests then meet the missing
library exactly as they would without this hook.
"""

import os
import subprocess

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker: the controller built it
        return
    try:
        subprocess.run(["make", "-C", _SRC], capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        pass
