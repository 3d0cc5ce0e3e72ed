"""The port as an installed package.

A wheel built offline by pip from a copy of the tree under ``tmp_path``
(never in the repo root, where setuptools would leave ``*.egg-info``)
carries every file of ``taichislam_tpu_torch/``, the kernel sources
(``csrc/*.cu``) and the native transport's ``runtime/transport.cpp``
included. Installed into a site directory, the package imports from there,
finds its sources there and builds beside it, in ``<site>/build/``.
"""

import json
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys
from pathlib import Path
import taichislam_tpu_torch
from taichislam_tpu_torch import runtime
from taichislam_tpu_torch.core import GridSpec, TSDFConfig
from taichislam_tpu_torch.models import DenseESDF, DenseTSDF
from taichislam_tpu_torch.node import TaichiSLAMNodeCore
from taichislam_tpu_torch.ops.kernels import build
from taichislam_tpu_torch.tools import gen_fixtures
print(json.dumps({
    "file": taichislam_tpu_torch.__file__,
    "kernel_sources": [str(p) for p in build._sources()],
    "kernels": str(build.library_path()),
    "transport_src": str(runtime.SRC),
    "native": runtime.native_available(),
    "transport": str(runtime.library_path()),
    "fixtures": str(gen_fixtures.FIXTURE_DIR)}))
"""


# pip with no index, no dependencies and no version check: nothing online
PIP_OFFLINE = ("--no-deps", "--no-index", "--disable-pip-version-check")


def _pip(cwd, *args):
    res = subprocess.run([sys.executable, "-m", "pip", *args, *PIP_OFFLINE],
                         cwd=cwd, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


def test_installed_wheel_is_whole(tmp_path):
    src, dist = tmp_path / "src", tmp_path / "dist"
    src.mkdir()
    shutil.copy2(ROOT / "pyproject.toml", src)
    for pkg in ("taichislam_tpu", "taichislam_tpu_torch"):
        shutil.copytree(ROOT / pkg, src / pkg, ignore=shutil.ignore_patterns(
            "__pycache__", "*.pyc", "*.so"))
    _pip(src, "wheel", str(src), "--no-build-isolation", "-w", str(dist))
    [whl] = dist.glob("*.whl")
    names = set(zipfile.ZipFile(whl).namelist())
    pkg = ROOT / "taichislam_tpu_torch"
    files = {"taichislam_tpu_torch/" + p.relative_to(pkg).as_posix()
             for p in pkg.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts and p.suffix != ".pyc"}
    data = {f for f in files if not f.endswith(".py")}
    assert {"taichislam_tpu_torch/runtime/transport.cpp",
            "taichislam_tpu_torch/csrc/seg_accum.cu",
            "taichislam_tpu_torch/csrc/esdf_sweep.cu"} <= data
    assert sorted(files - names) == []
    assert not (ROOT / "taichislam_tpu.egg-info").exists()

    site = tmp_path / "site"
    _pip(tmp_path, "install", "--target", str(site), str(whl))
    env = dict(os.environ, PYTHONPATH=str(site))
    res = subprocess.run([sys.executable, "-c", CHILD], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    inside = site / "taichislam_tpu_torch"
    assert Path(got["file"]).parent == inside
    assert [Path(p).name for p in got["kernel_sources"]] == [
        "esdf_sweep.cu", "seg_accum.cu"]
    assert all(Path(p).parent == inside / "csrc"
               for p in got["kernel_sources"])
    assert Path(got["kernels"]).parent == site / "build" / "kernels"
    assert Path(got["transport_src"]) == inside / "runtime" / "transport.cpp"
    assert Path(got["transport"]).parent == site / "build" / "runtime"
    assert Path(got["fixtures"]) == site / "build" / "fixtures"
    # g++ builds the installed copy's transport from its own source
    assert got["native"] is True
    assert Path(got["transport"]).exists()
