"""ctypes wrappers over the native control plane and timeline writer
(counterpart of `horovod_tpu/_native/control_plane.py`)."""

from __future__ import annotations

import ctypes
import os
from typing import Optional

from . import load


class NativeUnavailable(RuntimeError):
    pass


def _lib():
    lib = load()
    if lib is None:
        raise NativeUnavailable("native control plane not built/loadable")
    return lib


class NativeRendezvousServer:
    """Engine of `runner.rendezvous.RendezvousServer`: the same wire
    protocol, served by the C++ thread-per-connection server."""

    def __init__(self, secret: str):
        self._libref = _lib()
        self._secret = secret
        self._handle: Optional[int] = None

    def start(self, port: int = 0) -> int:
        bound = ctypes.c_int(0)
        handle = self._libref.hvdtpu_cp_start(
            self._secret.encode(), port, ctypes.byref(bound))
        if not handle:
            raise NativeUnavailable(f"native server failed to bind port {port}")
        self._handle = handle
        return bound.value

    def stop(self) -> None:
        if self._handle is not None:
            self._libref.hvdtpu_cp_stop(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.stop()
        # lint: allow-swallow(__del__ at interpreter shutdown must not raise)
        except Exception:
            pass


class NativeTimelineWriter:
    """Writer backend of `utils.timeline.Timeline`: an event costs one
    ctypes call into the C++ buffered writer thread (reference:
    timeline.cc TimelineWriter)."""

    def __init__(self, path: str, pid: Optional[int] = None):
        self._libref = _lib()
        self._handle = self._libref.hvdtpu_tl_open(
            path.encode(), pid if pid is not None else os.getpid())
        if not self._handle:
            raise NativeUnavailable(f"cannot open timeline file {path}")

    def event(self, name: str, cat: str, ph: str, ts_us: float,
              dur_us: float = -1.0, pid: int = 0, tid: str = "",
              scope: str = "", args_json: str = "",
              extra_json: str = "") -> None:
        self._libref.hvdtpu_tl_event2(
            self._handle, name.encode(), cat.encode(), ph.encode(),
            float(ts_us), float(dur_us), pid, tid.encode(), scope.encode(),
            args_json.encode(), extra_json.encode())

    def close(self) -> None:
        if self._handle:
            self._libref.hvdtpu_tl_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        # lint: allow-swallow(__del__ at interpreter shutdown must not raise)
        except Exception:
            pass
