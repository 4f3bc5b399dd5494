"""Native (C++) control plane, loaded through ctypes (counterpart of
`horovod_tpu/_native/`).

Reference parity: the reference's runtime is C++ (horovod/common/*.cc);
what of it stays host-side here is the control plane (the rendezvous KV
and its barriers, which the launcher and the elastic driver serve) and
the timeline writer (SURVEY.md §7).  `src/control_plane.cc` is the JAX
package's engine: an HMAC-authenticated KV server speaking the wire of
`runner/rendezvous.py` byte for byte, and a buffered Chrome-trace
writer thread.

The library is built with the host's `g++` (not nvcc: it has no device
code) at first use, into `horovod_tpu_torch/build/` (git-ignored), named
by a hash of the source and the flags, so an edited source builds anew:

    g++ -O2 -std=c++17 -shared -fPIC -pthread \\
        -o build/libhvd_control_plane-<hash>.so _native/src/control_plane.cc

Every consumer has a pure-Python fallback (`RendezvousServer` serves in
Python, the timeline writes from a Python thread), so a host without a
compiler still runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional

logger = logging.getLogger("horovod_tpu_torch._native")

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "src", "control_plane.cc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lib = None
_lib_lock = threading.Lock()


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    with open(SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libhvd_control_plane-{h.hexdigest()[:16]}.so")


def _build(lib: str) -> bool:
    # Compile to a process-unique temp path and os.replace into place:
    # concurrent builders in separate processes never publish a
    # truncated library.
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        out = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SRC],
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            logger.warning("native build failed:\n%s", out.stderr)
            return False
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.info("native build failed to run: %s", e)
        return False
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def load(build_if_missing: bool = True) -> Optional[ctypes.CDLL]:
    """Load the native library; None if unavailable.

    `build_if_missing=False` callers are on latency-sensitive paths (the
    timeline inside `hvd.init()`) and only accept a built library: a
    synchronous g++ run there would stall every rank's start.
    """
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            if not build_if_missing or not _build(path):
                return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            logger.warning("cannot load %s: %s", path, e)
            return None
        lib.hvdtpu_cp_start.restype = ctypes.c_void_p
        lib.hvdtpu_cp_start.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.hvdtpu_cp_stop.argtypes = [ctypes.c_void_p]
        lib.hvdtpu_tl_open.restype = ctypes.c_void_p
        lib.hvdtpu_tl_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.hvdtpu_tl_event2.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p]
        lib.hvdtpu_tl_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib
