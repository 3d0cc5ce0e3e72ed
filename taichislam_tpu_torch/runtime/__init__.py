"""Native runtime components (C++ + ctypes).

Counterpart of the JAX package's ``runtime/__init__.py``.
``NativeUDPMulticastTransport`` wraps ``transport.cpp`` beside this file: an
LCM-UDPM-wire-compatible multicast transport with a background receive
thread (the role the native LCM C library plays for TaichiSLAM). At first
use ``g++`` builds it into ``build/runtime/`` beside the package, never into
it: at the repository root in a checkout (listed in ``.gitignore``), in
``<site-packages>/build/runtime/`` in an installed copy, which must be
writable. The file name carries a hash of the source and flags, so an
edited source builds anew. ``native_available()`` reports whether the
library built and loaded; callers then fall back to the pure-Python
transport (host networking, as in the JAX package). Nothing here runs at
import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Tuple

SRC = Path(__file__).resolve().parent / "transport.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "runtime"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_LIB = None
_LIB_TRIED = False


def library_path() -> Path:
    h = hashlib.sha1(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libtslam_transport_{h.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, out)


def _load():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.tslam_transport_create.restype = ctypes.c_void_p
    lib.tslam_transport_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                           ctypes.c_int]
    lib.tslam_transport_destroy.argtypes = [ctypes.c_void_p]
    lib.tslam_transport_publish.restype = ctypes.c_int
    lib.tslam_transport_publish.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                            ctypes.c_char_p, ctypes.c_size_t]
    lib.tslam_transport_poll.restype = ctypes.c_long
    lib.tslam_transport_poll.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, ctypes.c_size_t]
    _LIB = lib
    return lib


def native_available() -> bool:
    return _load() is not None


class NativeUDPMulticastTransport:
    """Same interface as utils.comm.UDPMulticastTransport (publish/poll/
    close), backed by the C++ library; receive runs on a native thread so
    bursts of submap fragments are drained without the GIL."""

    MAX_MSG = 64 * 1024 * 1024

    def __init__(self, url: str = "udpm://224.0.0.251:7667?ttl=1"):
        from taichislam_tpu_torch.utils.comm import _parse_udpm_url
        lib = _load()
        if lib is None:
            raise OSError(f"native transport did not build from {SRC.name}")
        addr, port, ttl = _parse_udpm_url(url)
        self._lib = lib
        self._h = lib.tslam_transport_create(addr.encode(), port, ttl)
        if not self._h:
            raise OSError(f"native transport failed to bind {addr}:{port}")
        self._chan_buf = ctypes.create_string_buffer(256)
        self._data_buf = ctypes.create_string_buffer(self.MAX_MSG)

    def publish(self, channel: str, data: bytes):
        rc = self._lib.tslam_transport_publish(self._h, channel.encode(),
                                               bytes(data), len(data))
        if rc != 0:
            raise OSError("native transport publish failed")

    def poll(self, timeout_ms: int) -> List[Tuple[str, bytes]]:
        out = []
        remaining = timeout_ms
        while True:
            n = self._lib.tslam_transport_poll(
                self._h, max(remaining, 0), self._chan_buf, 256,
                self._data_buf, self.MAX_MSG)
            if n < 0:
                break
            out.append((self._chan_buf.value.decode(),
                        self._data_buf.raw[:n]))
            remaining = 0  # drain whatever is already queued
        return out

    def close(self):
        if self._h:
            self._lib.tslam_transport_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
