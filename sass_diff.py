"""Compare the machine code (SASS) of the hand-written CUDA kernels of this
checkout with that of another checkout's sources, function by function:

    python3 sass_diff.py OTHER_ROOT [LIBRARY ...]

OTHER_ROOT is the root of another copy of the repository (a `git archive`
of the parent commit, say); LIBRARY names default to every kernel library
of `ray_tpu_torch.ops._kernels.KERNELS`. Both trees' `csrc/<name>.cu` are
compiled here with this checkout's nvcc command (nothing of the other tree
is imported or run) into `ray_tpu_torch/ops/_build/sass/`, then dumped with
the CUDA toolkit's `cuobjdump --dump-sass`. A function's instructions are
compared without their addresses and encodings, and with the per-file tag
of the anonymous namespace taken out of every name (it differs between two
copies of one source). Prints one JSON line per library: the functions of
each side, and those whose instructions differ or that one side lacks.
Needs nvcc and cuobjdump (a machine with the CUDA toolkit).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

from ray_tpu_torch.ops import _kernels

OUT = _kernels.BUILD_DIR / "sass"
# _GLOBAL__N__<hash>_<len>_<file>_cu_<hash>: the anonymous namespace's tag.
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")


def compile_library(csrc: Path, name: str, side: str) -> Path:
    """`csrc/<name>.cu` built with the kernels' own nvcc flags."""
    out = OUT / side / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(out),
                    str(csrc / f"{name}.cu")], capture_output=True, text=True,
                   timeout=600, check=True)
    return out


def sass(library: Path) -> Dict[str, List[str]]:
    """{function: its instructions} of one built library."""
    cuobjdump = str(Path(_kernels._nvcc()).parent / "cuobjdump")
    out = subprocess.run([cuobjdump, "--dump-sass", str(library)],
                         capture_output=True, text=True, timeout=300, check=True)
    funcs, fn = {}, None
    for line in out.stdout.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = _ANON.sub("_GLOBAL__N_", head.group(1))
            funcs[fn] = []
            continue
        insn = _INSN.search(line)
        if fn is not None and insn:
            funcs[fn].append(_ANON.sub("_GLOBAL__N_", insn.group(1)))
    return funcs


def compare(other_root: Path, names) -> List[dict]:
    other_csrc = other_root / "ray_tpu_torch" / "ops" / "csrc"
    jobs = [(csrc, name, side) for name in names
            for csrc, side in ((_kernels.CSRC, "here"), (other_csrc, "other"))]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda job: compile_library(*job), jobs))
    rows = []
    for i, name in enumerate(names):
        mine, theirs = sass(built[2 * i]), sass(built[2 * i + 1])
        rows.append({
            "library": name,
            "functions": len(mine), "other_functions": len(theirs),
            "instructions": sum(len(v) for v in mine.values()),
            "differ": sorted(f for f in mine.keys() & theirs.keys() if mine[f] != theirs[f]),
            "only_here": sorted(mine.keys() - theirs.keys()),
            "only_other": sorted(theirs.keys() - mine.keys()),
        })
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other_root", type=Path)
    p.add_argument("libraries", nargs="*", default=list(_kernels.KERNELS))
    args = p.parse_args(argv)
    for row in compare(args.other_root.resolve(), args.libraries):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
