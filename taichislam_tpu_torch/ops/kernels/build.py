"""Build the CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` file compiles to an object with its own nvcc, all
started together, and the objects link into one shared library with a
plain C interface, at first use, into ``build/kernels/`` beside the
package: at the repository root in a checkout (listed in ``.gitignore``),
in ``<site-packages>/build/kernels/`` in an installed copy, which must be
writable. The file name carries a hash of the sources and flags, so an
edited source builds anew. Nothing here runs at import. :func:`count`
keeps the wrappers' launch and work counters true under CUDA graph capture
and replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from taichislam_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_int64
F32 = ctypes.c_float
PP = ctypes.POINTER(ctypes.c_void_p)
PI64 = ctypes.POINTER(ctypes.c_int64)

# C entry points: name -> argtypes (every one returns cudaGetLastError())
SIGNATURES = {
    "seg_accum_launch": [P, P, PP, PI64, I64, I32, I32, I64, I64, I32, I32,
                         I64, I32, I32, P, P, P, P, P, I64, P],
    "esdf_sweep_launch": [P] * 5 + [I32] * 2 + [F32] * 6 + [I32, P, I32,
                                                            P],
    "esdf_loop_launch": [P] * 7 + [I32] * 2 + [F32] * 7 + [I32] * 3 + [
        P, I32, P],
    "esdf_max_clusters": [I32, I32, ctypes.POINTER(I32)],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtaichislam_kernels_{h.hexdigest()[:12]}.so"


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        nvcc = _nvcc()
        objs, jobs = [], []
        for src in _sources():
            obj = BUILD_DIR / f"{src.stem}.{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            objs.append(obj)
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                *map(str, objs)]
        log, failed = [], []
        for cmd, proc in jobs:
            text = proc.communicate()[0]
            log.append(" ".join(cmd) + "\n" + text)
            if proc.returncode != 0:
                failed.append(text[-4000:])
        if not failed:
            res = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + res.stdout + res.stderr)
            if res.returncode != 0:
                failed.append(res.stderr[-4000:])
        (BUILD_DIR / "build.log").write_text("\n".join(log))
        for obj in objs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


# the launches a CUDA graph capture records in this thread (see count)
_capture = threading.local()


def count(fn, site=None, work=None) -> None:
    """Count one launch of ``fn``'s kernel (``fn.launches`` and, with a
    ``site``, ``fn.site_launches[site]``) and its ``work`` ({counter name:
    amount}, added to ``utils/profiling``'s counters). While this thread
    captures a CUDA graph under :func:`capture_tally` nothing runs yet: the
    launch goes into the capture's tally instead, and every replay of the
    graph adds the tally through :func:`add_counts`."""
    import torch
    tally = getattr(_capture, "tally", None)
    if tally is not None and torch.cuda.is_current_stream_capturing():
        tally.append((fn, site, work))
    else:
        add_counts([(fn, site, work)])


def add_counts(tally, times: int = 1) -> None:
    """Add ``times`` launches, and their work, of every (fn, site, work)
    entry of ``tally``."""
    for fn, site, work in tally:
        fn.launches += times
        if site is not None:
            fn.site_launches[site] = fn.site_launches.get(site, 0) + times
        for name, n in (work or {}).items():
            profiling.count(name, n * times)


@contextlib.contextmanager
def capture_tally():
    """Collect the launches :func:`count` sees while this thread captures
    a graph; yields the tally, a list of (fn, site, work)."""
    tally = []
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = None
