"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. It is compiled by `nvcc` for
sm_90a into `insr_pde_tpu_torch/_build/` (listed in `.gitignore`) at first
use, keyed on the hash of the source (with the `csrc/` headers it includes)
and the flags, and loaded with `ctypes`. Nothing is built or imported when
this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# -Xptxas=-v only adds the register/shared-memory report to the compiler's
# output; it does not change the binary.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or in "
                       "/usr/local/cuda/bin; the CUDA kernels cannot be built")


def expand_includes(text: str) -> str:
    """`text` with each `#include "NAME"` line replaced by `csrc/NAME`
    (itself expanded, once per translation unit, as `#pragma once` does):
    one self-contained source, for copies built or compiled elsewhere."""
    seen = set()

    def inline(m):
        name = m.group(1)
        if name in seen:
            return ""
        seen.add(name)
        body = (CSRC / name).read_text().replace("#pragma once\n", "")
        return re.sub(r'^#include "([^"]+)"\n', inline, body, flags=re.M)

    return re.sub(r'^#include "([^"]+)"\n', inline, text, flags=re.M)


def source_text(name: str) -> str:
    """`csrc/<name>.cu` with its `csrc/` headers inlined."""
    return expand_includes((CSRC / f"{name}.cu").read_text())


def library_path(name: str) -> Path:
    src = source_text(name).encode()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one `nvcc` per
    source, all started together. Returns name -> compiler output (empty
    for a library that was already built). Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, target)   # atomic: a concurrent build sees all or none
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            tic = time.perf_counter()
            build([name])
            print(f"built {path.name} in {time.perf_counter() - tic:.1f}s")
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
