"""Build the port's CUDA sources at first use and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface (no PyTorch headers), so
`nvcc` builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

The library lands in `horovod_tpu_torch/build/` (listed in .gitignore),
named by a hash of the source and the flags, so an edited source builds
anew and an unchanged one is reused.  `nvcc -Xptxas -v` output (each
kernel's registers, shared memory and spills) is kept beside it as
`<lib>.log`.  Builds of several sources run in parallel, one `nvcc` each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

from .common.exceptions import HorovodTpuError

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of every CUDA source of the port (csrc/<name>.cu)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise HorovodTpuError("nvcc not found (set CUDA_HOME); the port's CUDA "
                          "kernels are built from csrc/ at first use")


def _library_path(name: str) -> str:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def available() -> bool:
    """True when every source can be had without building here: its
    library is built, or `nvcc` is found to build it at first use.
    Builds nothing and touches no card (the launcher's --check-build)."""
    if all(os.path.exists(_library_path(n)) for n in sources()):
        return True
    try:
        _nvcc()
    except HorovodTpuError:
        return False
    return True


def build(names: Iterable[str]) -> None:
    """Build every named source that has no current library, all
    `nvcc`s started together; raise if one fails."""
    todo = [(n, _library_path(n)) for n in names]
    todo = [(n, so) for n, so in todo if not os.path.exists(so)]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, so in todo:
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}:\n{out}")
            continue
        with open(so + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, so)  # atomic: a concurrent build sees all or none
    if failed:
        raise HorovodTpuError("nvcc failed for " + "\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_library_path(name))
            _libs[name] = lib
        return lib
