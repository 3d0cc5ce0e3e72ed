"""Import isolation: the port imports neither JAX nor the JAX package.

In a fresh interpreter whose ``sys.meta_path`` refuses ``jax``, ``jaxlib``
and ``taichislam_tpu`` (but not ``taichislam_tpu_torch``), every module of
``taichislam_tpu_torch`` found by ``pkgutil.walk_packages`` and
``chip_smoke.py`` import. A module whose only missing imports are ROS's
(``rospy``, ``message_filters``, the message packages) is skipped and named;
the ROS shell is driven under a fake ROS in test_torch_ros_shell.py.
"""

import json
import subprocess
import sys
from pathlib import Path

from tests import test_torch_api as api

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib
import importlib.abc
import importlib.util
import json
import pkgutil
import sys

REFUSED = ("jax", "jaxlib", "taichislam_tpu")
ROS = {"rospy", "message_filters", "sensor_msgs", "geometry_msgs",
       "std_msgs", "swarm_msgs", "rosbag"}
for name in [m for m in sys.modules if m.split(".")[0] in REFUSED]:
    del sys.modules[name]


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {name}", name=name)
        return None


sys.meta_path.insert(0, Refuse())
import taichislam_tpu_torch

out = {"imported": [], "skipped": [], "failed": []}


def load(name, fn):
    try:
        fn()
        out["imported"].append(name)
    except ImportError as e:
        missing = (e.name or "").split(".")[0]
        if isinstance(e, ModuleNotFoundError) and missing in ROS:
            out["skipped"].append([name, e.name])
        else:
            out["failed"].append([name, repr(e)])


for info in pkgutil.walk_packages(taichislam_tpu_torch.__path__,
                                  "taichislam_tpu_torch."):
    load(info.name, lambda n=info.name: importlib.import_module(n))


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  "chip_smoke.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))


load("chip_smoke", chip_smoke)
out["leaked"] = sorted(m for m in sys.modules
                       if m.split(".")[0] in REFUSED)
print(json.dumps(out))
"""


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["failed"] == [], out["failed"]
    assert out["leaked"] == []
    # only the rospy shell needs ROS; it is named here
    assert [m for m, _ in out["skipped"]] == [
        "taichislam_tpu_torch.node.ros_node"], out["skipped"]
    print("skipped (ROS missing):", out["skipped"])
    imported = set(out["imported"])
    for name in ("chip_smoke", "taichislam_tpu_torch.node.core",
                 "taichislam_tpu_torch.utils.comm",
                 "taichislam_tpu_torch.utils.lcm_codec",
                 "taichislam_tpu_torch.utils.ros_pcl_transfer",
                 "taichislam_tpu_torch.utils.visualization",
                 "taichislam_tpu_torch.utils.viewer_server",
                 "taichislam_tpu_torch.utils.viewer_softrender",
                 "taichislam_tpu_torch.utils.profiling",
                 "taichislam_tpu_torch.runtime",
                 "taichislam_tpu_torch.demo",
                 "taichislam_tpu_torch.examples.demo_synthetic",
                 "taichislam_tpu_torch.examples.gen_topo_graph",
                 "taichislam_tpu_torch.bench",
                 "taichislam_tpu_torch.tools.bench_configs",
                 "taichislam_tpu_torch.tools.bench_secondary",
                 "taichislam_tpu_torch.tools.compare_vs_reference",
                 "taichislam_tpu_torch.tools.gen_fixtures",
                 "taichislam_tpu_torch.tools.reference_math",
                 "taichislam_tpu_torch.tools.viewer_demo_scene",
                 "taichislam_tpu_torch.ops.kernels.seg_accum",
                 "taichislam_tpu_torch.ops.kernels.esdf_sweep"):
        assert name in imported, name


PACKAGES_ALONE = r"""
want = json.loads(sys.argv[1])
out = {"missing": {}, "bad": []}
for pkg, names in want.items():
    # each package alone: a sibling's import must not bind its names
    for m in [m for m in sys.modules if m.startswith("taichislam_tpu_torch")]:
        del sys.modules[m]
    mod = importlib.import_module(pkg)
    lack = sorted(n for n in names if not hasattr(mod, n))
    if lack:
        out["missing"][pkg] = lack
    out["bad"] += [m for m in sys.modules
                   if "ros_node" in m or m.split(".")[0] in REFUSED]
import torch
out["cuda_initialized"] = torch.cuda.is_initialized()
print(json.dumps(out))
"""


def test_reexported_names_import_without_jax():
    """The JAX package's import forms with the port's package name: each
    port package, imported alone in an interpreter that refuses the JAX
    package, binds every name its JAX counterpart's ``__init__`` binds,
    imports no rospy shell (node/ros_node.py) and starts no CUDA."""
    want = {api.port_module_name(rel): sorted(
        n for n in api.bound_names(api._parse(api.JAX_PKG / rel))
        if not n.startswith("_") or n == "__version__")
        for rel in api.JAX_INITS}
    for pkg, names in (("models", {"DenseESDF", "DenseTSDF"}),
                       ("core", {"GridSpec", "TSDFConfig"}),
                       ("node", {"TaichiSLAMNodeCore"}),
                       ("ops", {"tsdf"})):
        assert names <= set(want["taichislam_tpu_torch." + pkg]), pkg
    probe = SCRIPT.split("import taichislam_tpu_torch")[0] + PACKAGES_ALONE
    res = subprocess.run([sys.executable, "-c", probe, json.dumps(want)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == {"missing": {}, "bad": [], "cuda_initialized": False}


def test_refusal_is_effective():
    """The same finder does refuse the JAX package (a check of the check)."""
    probe = SCRIPT.split("import taichislam_tpu_torch")[0] + (
        "\ntry:\n    import taichislam_tpu.core.config\n"
        "    print('imported')\nexcept ImportError:\n    print('refused')\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.stdout.strip() == "refused", res.stderr[-2000:]
