"""BENCHMARK.json against the files it names, and the harness finding a
cell's pieces by name: a new cell made only of new files runs."""

import json
import re
import shutil

import pytest
import torch

from benchmark.cells import ROOT, Cell, benchmark_spec
from benchmark.harness import run_cell
from benchmark.loop import HostClock, run_window
from benchmark.tests.helpers import CELLS

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = benchmark_spec()


def test_names_units_and_files():
    names = set()
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[key]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in names
            names.add(e["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    moves = {m["name"] for m in SPEC["end_to_end"]}
    assert all(m["moves"] in moves for m in SPEC["per_layer"])
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        cell = Cell(w["name"])
        assert cell.limits, f"no checks/{w['name']}.json"
        assert cell.scene().render
        assert cell.metrics(False) and cell.metrics(True)
        assert "setup_s" in {m["name"] for m in cell.metrics(False)}


class FakeNode:
    def stage(self, k):
        pass

    def process(self):
        return False


def test_new_cell_from_new_files_only(tmp_path):
    """A throwaway configuration, traffic mix, scene and metric, added as
    files next to copies of the existing ones, are found by name."""
    here = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (here / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "params": {"~voxel_scale": 0.2}, "comm": "none",
         "reduced": [], "assumed": []}))
    (here / "traffic" / "burst.json").write_text(json.dumps(
        {"name": "burst", "loop": "open", "rate_hz": 100.0,
         "scene": "flat", "warmup_frames": 0}))
    (here / "scenes" / "flat.py").write_text(
        "BOUNDS_LO = (-1, -1, -1)\nBOUNDS_HI = (1, 1, 1)\n"
        "def render(traffic, K, seed, device, with_texture):\n"
        "    return {'seed': seed}\n")
    (here / "metrics" / "frames_done.py").write_text(
        "def read(run):\n    return float(len(run['frames']))\n")
    (here / "checks" / "toy.burst.json").write_text(json.dumps(
        {"limits": {"tsdf_gap": {"limit": 0.1}}}))
    spec["configs"].append({"name": "toy", "source": "https://example.org",
                            "file": "benchmark/configs/toy.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "toy.burst", "config": "toy",
                              "traffic": "burst", "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "frames_done", "unit": "frames",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "setup_s",
                              "workloads": ["toy.burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = Cell("toy.burst", root=tmp_path, here=here)
    assert cell.params == {"~voxel_scale": 0.2}
    assert cell.limits == {"tsdf_gap": {"limit": 0.1}}
    assert cell.scene().render(cell.traffic, None, 7, None, False) == \
        {"seed": 7}
    assert "frames_done" in {m["name"] for m in cell.metrics(True)}
    recs, attempted, dropped = run_window(
        FakeNode(), HostClock(), cell.traffic["loop"],
        cell.traffic["rate_hz"], 0.05)
    run = {"frames": recs}
    assert cell.reader("frames_done")(run) == float(len(recs))
    assert attempted == 5 and dropped == 0
    with pytest.raises(FileNotFoundError):
        cell.reader("no_such_metric")


def test_new_mix_without_keyframes_from_new_files_only(tmp_path):
    """A hover-like mix with no keyframe flags, added as a traffic file, a
    limits file, a metric reader and entries: the submap node makes no
    boundary in it, and the reference, given the same flags, agrees."""
    here = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((here / "traffic" / "orbit30.json").read_text())
    (here / "traffic" / "still.json").write_text(json.dumps(
        dict(mix, name="still", keyframe_every=0)))
    (here / "checks" / "d435_submap_tsdf.still.json").write_text(
        (here / "checks" / "d435_submap_tsdf.orbit30.json").read_text())
    (here / "metrics" / "boundaries.py").write_text(
        "def read(run):\n"
        "    return float(sum(r['boundary'] for r in run['frames']))\n")
    spec["workloads"].append({"name": "d435_submap_tsdf.still",
                              "config": "d435_submap_tsdf",
                              "traffic": "still", "chips": 1, "why": "t"})
    spec["end_to_end"].append({"name": "boundaries", "unit": "frames",
                               "better": "lower", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["d435_submap_tsdf.still"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    line = run_cell(Cell("d435_submap_tsdf.still", root=tmp_path, here=here),
                    2 ** 31 + 9, 1.0, False, torch.device("cpu"),
                    frames_override=CELLS["d435_submap_tsdf.orbit30"])
    assert line["metrics"]["boundaries"]["value"] == 0.0
    assert line["correct"], line["checks"]
