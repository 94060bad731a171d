"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), named
after a hash of its sources so an edited kernel never loads a stale build.
Libraries land in ``_build/`` beside this file (git-ignored) at first use
and load with ``ctypes``. Nothing here runs at import: the CPU-only test
environment imports every module and never builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = (
    "paged_attention", "flash_fwd", "flash_bwd", "flash_bwd_fused",
    "attn_dissect", "attn_slim", "attn_subtile",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Storage-type codes shared with the C entry points.
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "int8": 2}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def dtype_code(dtype) -> int:
    name = str(dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise ValueError(f"no CUDA kernel instantiation for dtype {dtype}")
    return DTYPE_CODES[name]


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build from "
            "ray_tpu_torch/ops/csrc at first use"
        )
    return found


def _library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every named kernel that has no current build, one ``nvcc``
    per source, all started together. Returns {name: {"seconds", "log"}}
    for the sources compiled (ptxas' register/shared-memory report is the
    log). Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp, target, time.perf_counter(),
        )
    report, failures = {}, []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, target)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return report


def library(name: str, argtypes: Optional[Dict[str, list]] = None) -> ctypes.CDLL:
    """The loaded library for kernel `name`, built first if needed.
    `argtypes` maps each C entry point to its ctypes argument list
    (``c_void_p`` for every pointer and the stream: a bare Python int
    would be passed as a 32-bit int and cut the pointer), or to a pair
    (argument list, return type) for an entry that returns something other
    than a ``cudaError_t``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            for fn, types in (argtypes or {}).items():
                args, ret = types if isinstance(types, tuple) else (types, ctypes.c_int)
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ret
            _libs[name] = lib
        return lib


def check(err: int, kernel: str) -> None:
    """Raise on a non-zero cudaGetLastError() returned by a launch: a
    refused launch never runs, and a later synchronize would not say so."""
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")
