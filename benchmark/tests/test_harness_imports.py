"""What a run loads, and the entry point's refusals on a machine without a
card. Module names are compared by their whole top-level name: the port's
name begins with the JAX package's."""

import json
import os
import shutil
import subprocess
import sys

from benchmark.cells import ROOT

TOP = "sorted({m.split('.')[0] for m in sys.modules})"


def _python(code, cwd=ROOT, env=None):
    res = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_run_loads_no_jax():
    """A whole (CPU-sized) run, reference included, loads neither JAX nor
    the JAX package."""
    top = _python(
        "import sys, json\n"
        "from benchmark.tests.helpers import tiny_run\n"
        "tiny_run('node_esdf_textured.orbit_backlog')\n"
        "from benchmark.run import refused_modules\n"
        f"print(json.dumps([refused_modules(), {TOP}]))")
    refused, loaded = top
    assert refused == []
    assert not {"jax", "jaxlib", "flax", "taichislam_tpu"} & set(loaded)
    assert "taichislam_tpu_torch" in loaded


def test_reference_loads_nothing_of_the_program():
    top = _python(
        "import sys, json, types, numpy as np, torch\n"
        "from benchmark.reference.node import NodeReference\n"
        "from benchmark.scenes import office\n"
        "from benchmark.harness import Frames\n"
        "t = dict(distinct_frames=2, height=48, width=64,\n"
        "         orbit_radius_m=0.8, depth_noise_mm=3.0)\n"
        "K = np.array([384., 0, 32., 0, 384., 24., 0, 0, 1], np.float32)\n"
        "s = office.render(t, K, 5, torch.device('cpu'), True)\n"
        "f = Frames(s, True)\n"
        "r = NodeReference({'~mapping_type': 'esdf', '~output_map': True,\n"
        "    '~esdf/publish_slice_z': 0.0}, (office.BOUNDS_LO,\n"
        "    office.BOUNDS_HI), torch.device('cpu'))\n"
        "for g in range(2):\n"
        "    fr, src = f.frame(g)\n"
        "    r.frame(fr, torch.from_numpy(s['depth'][src].astype(np.int32)),\n"
        "            torch.from_numpy(s['texture'][src]), export=True)\n"
        "r.esdf_field()\n"
        f"print(json.dumps({TOP}))")
    assert not {"taichislam_tpu_torch", "taichislam_tpu", "jax"} & set(top)


def test_entry_point_refuses_without_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    args = [sys.executable, "-m", "benchmark.run", "--workload",
            "d435_submap_tsdf.orbit30", "--seed", str(2 ** 33 + 1),
            "--seconds", "1", "--trace", "0"]
    res = subprocess.run(args, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode != 0 and res.stdout.strip() == ""
    # a directory with BENCHMARK.json and the benchmark's files alone
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(args, cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode != 0 and res.stdout.strip() == ""
