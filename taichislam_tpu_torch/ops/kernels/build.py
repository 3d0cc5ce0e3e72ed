"""Build the CUDA kernels with nvcc and load them with ctypes.

All ``csrc/*.cu`` files compile into one shared library with a plain C
interface, at first use, into ``build/kernels/`` at the repository root
(listed in ``.gitignore``). The file name carries a hash of the sources
and flags, so an edited source builds anew. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_int64
F32 = ctypes.c_float

# C entry points: name -> argtypes (every one returns cudaGetLastError())
SIGNATURES = {
    "seg_accum_launch": [P, P, P, I64, I32, I32, I64, I32, P, P, P, P, P],
    "esdf_sweep_launch": [P] * 5 + [I32] * 2 + [F32] * 6 + [I32, P],
    "esdf_loop_sweep_launch": [P] * 10 + [I32] * 3 + [F32] * 7 + [I32, P],
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
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(s) for s in _sources()]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        (BUILD_DIR / "build.log").write_text(
            " ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stderr[-4000:]}")
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
