"""The port's measurement entry points (``taichislam_tpu_torch/tools/``)
against the repository's JAX-side tools.

- ``reference_math``: the copies of ``tests/reference_math.py`` and of
  ``tests/test_tsdf.py::mask_boundary_pixels`` are the same source text and
  give the same dicts.
- ``compare_vs_reference``: passes on the CPU; the port's voxel -> SDF dict
  has the keys of the JAX ``DenseTSDF``'s on the same frames, its SDF within
  ``tests/test_torch_tsdf.py``'s float32 bound (2e-3).
- ``gen_fixtures``: the sequence equals the JAX ``orbit_sequence`` exactly;
  the saved map round-trips through ``DenseTSDF.loadMap``.
- config 4: ``tools/bench_configs.py::_run_voxgraph_once`` with the JAX
  classes against the port's with the port's, on the same frames at small
  options: submap registry, global block tables, observed flags and sent
  submap indices exact (as sets: the packages order a payload's voxels
  differently); TSDF and W within ``tests/test_torch_submap.py``'s
  bounds (TSDF 2e-3, W rtol 2e-3 / atol 1e-3).
- The CLIs: every one asks for the card unless ``--cpu`` (and raises
  without one, before any work); ``bench_configs --quick --cpu`` prints the
  rows of the configurations asked for; ``viewer_demo_scene`` starts and
  stops on port 0.
"""

import dataclasses
import inspect
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from taichislam_tpu.models.dense_tsdf import DenseTSDF as JDense  # noqa: E402,E501
from taichislam_tpu.models.submap_mapping import \
    SubmapMapping as JSM  # noqa: E402
from taichislam_tpu.models.submap_mapping import \
    _decode_submap_npz as jdecode  # noqa: E402
from taichislam_tpu.utils.synthetic_scene import \
    orbit_sequence as j_orbit_sequence  # noqa: E402
from taichislam_tpu_torch import bench  # noqa: E402
from taichislam_tpu_torch import bridge  # noqa: E402
from taichislam_tpu_torch.core import device as device_mod  # noqa: E402
from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF as TDense  # noqa: E402,E501
from taichislam_tpu_torch.models.submap_mapping import \
    SubmapMapping as TSM  # noqa: E402
from taichislam_tpu_torch.models.submap_mapping import \
    _decode_submap_npz as tdecode  # noqa: E402
from taichislam_tpu_torch.tools import bench_configs  # noqa: E402
from taichislam_tpu_torch.tools import bench_secondary  # noqa: E402
from taichislam_tpu_torch.tools import compare_vs_reference  # noqa: E402
from taichislam_tpu_torch.tools import gen_fixtures  # noqa: E402
from taichislam_tpu_torch.tools import reference_math  # noqa: E402
from taichislam_tpu_torch.tools import viewer_demo_scene  # noqa: E402
from tests import reference_math as j_reference_math  # noqa: E402
from tests import test_tsdf  # noqa: E402
from tools import bench_configs as j_bench_configs  # noqa: E402

DEV = torch.device("cpu")


# ---------------------------------------------------------------------------
# the reference math and the fidelity check
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["round_half_away", "sign", "w_x_p",
                                  "RefTSDF"])
def test_reference_math_is_the_same_source(name):
    assert inspect.getsource(getattr(reference_math, name)) == \
        inspect.getsource(getattr(j_reference_math, name))


def test_mask_boundary_pixels_is_the_same_source():
    assert inspect.getsource(reference_math.mask_boundary_pixels) == \
        inspect.getsource(test_tsdf.mask_boundary_pixels)


def test_reference_math_gives_the_same_map():
    seq = compare_vs_reference.frames(2)
    maps = []
    for mod in (reference_math, j_reference_math):
        ref = mod.RefTSDF(voxel=0.1, max_ray=2.0, min_ray=0.3, internal=10,
                          recast_step=2)
        for depth, R, T in seq:
            ref.integrate_depth(depth, compare_vs_reference.K, R, T)
        maps.append(ref)
    a, b = maps
    assert len(a.D) > 0
    assert a.D == b.D and a.W == b.W and a.obs == b.obs and a.occ == b.occ
    depth = test_tsdf.synthetic_depth()
    R = np.eye(3, dtype=np.float32)
    np.testing.assert_array_equal(
        reference_math.mask_boundary_pixels(depth, test_tsdf.K_DEP, R),
        test_tsdf.mask_boundary_pixels(depth, test_tsdf.K_DEP, R))


def test_fidelity_check_passes_on_cpu(capsys):
    assert compare_vs_reference.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert "FIDELITY: PASS" in out and "(cpu)" in out


def test_fidelity_sdf_matches_jax_dense_tsdf():
    """The port's voxel -> SDF dict against the JAX DenseTSDF's, built as
    the JAX tool builds it (its accumulation through the Pallas kernel in
    interpret mode, as tests/test_torch_tsdf.py runs it), on the same
    frames."""
    seq = compare_vs_reference.frames(3)
    got = compare_vs_reference.port_sdf(seq, DEV)
    m = JDense(**compare_vs_reference.MAP_OPTS)
    m.cfg = dataclasses.replace(m.cfg, pallas_accum="on")
    m.set_dep_camera_intrinsic(compare_vs_reference.K)
    for depth, R, T in seq:
        m.recast_depth_to_map(R, T, depth, None)
    idx, tsdf, _, _, _ = m.to_numpy()
    want = {tuple(int(x) for x in i): float(v) for i, v in zip(idx, tsdf)}
    assert got.keys() == want.keys() and len(want) > 1000
    keys = sorted(want)
    np.testing.assert_allclose([got[k] for k in keys],
                               [want[k] for k in keys], rtol=0, atol=2e-3)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

def test_fixture_sequence_is_the_jax_orbit(tmp_path):
    path = gen_fixtures.ensure_sequence(2, root=tmp_path)
    assert path.parent == tmp_path and path.name == "d435_synth_seq_2.npz"
    depth, Rs, Ts, K = j_orbit_sequence(n_frames=2)
    with np.load(path) as z:
        for name, want in (("depth", depth), ("Rs", Rs), ("Ts", Ts),
                           ("K", K)):
            assert z[name].dtype == want.dtype, name
            np.testing.assert_array_equal(z[name], want, err_msg=name)
    assert gen_fixtures.ensure_sequence(2, root=tmp_path) == path


def test_fixture_map_round_trips(tmp_path):
    """ensure_map's saved map loads back through DenseTSDF.loadMap: the same
    voxels, TSDF, W and occupancy as the map saved; a second call reuses
    the file. The sequence is cut to 160 x 120 so that the fusion stays
    small on the CPU."""
    depth, Rs, Ts, K = j_orbit_sequence(n_frames=2, h=120, w=160,
                                        K=np.asarray([96.0, 0, 80.0, 0, 96.0,
                                                      60.0, 0, 0, 1],
                                                     np.float32))
    np.savez_compressed(gen_fixtures.seq_path(2, tmp_path), depth=depth,
                        Rs=Rs, Ts=Ts, K=K)
    path = gen_fixtures.ensure_map(2, root=tmp_path, device=DEV)
    saved = np.load(path, allow_pickle=True).item()
    m = TDense.loadMap(path, device=DEV)
    assert m.device == DEV and m.count_active() == len(saved["TSDF"]) > 0
    back = m.export_submap()
    order = [np.lexsort(np.asarray(d["indices"]).T) for d in (saved, back)]
    for key in ("indices", "TSDF", "W_TSDF", "occupy"):
        np.testing.assert_array_equal(np.asarray(saved[key])[order[0]],
                                      np.asarray(back[key])[order[1]],
                                      err_msg=key)
    mtime = path.stat().st_mtime_ns
    assert gen_fixtures.ensure_map(2, root=tmp_path, device=DEV) == path
    assert path.stat().st_mtime_ns == mtime


# ---------------------------------------------------------------------------
# config 4: the voxgraph pass of both packages
# ---------------------------------------------------------------------------

VOX_OPTS = dict(map_scale=[6.4, 6.4], voxel_scale=0.1,
                num_voxel_per_blk_axis=8, max_ray_length=2.0,
                min_ray_length=0.3, max_blocks=512, max_bins=8192,
                max_fuse_voxels=1 << 15)
K_DEP = np.array([40.0, 0, 32.0, 0, 40.0, 24.0, 0, 0, 1], np.float32)


def _recording(cls):
    """``cls`` whose instances keep every payload they send."""
    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.sent = []
            self.map_send_handle = self.sent.append
    return Recording


def _vox_frames(n=8):
    jj, ii = np.meshgrid(np.arange(48), np.arange(64), indexing="ij")
    depth = np.stack([(1000 + 20 * t + 4.0 * ii + 2.0 * jj)
                      for t in range(n)]).astype(np.uint16)
    Rs, Ts = [], []
    for t in range(n):
        th = 0.04 * t
        Rs.append(np.array([[np.cos(th), -np.sin(th), 0],
                            [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                           np.float32))
        Ts.append(np.array([0.1 * t, 0.02 * t, 0.0], np.float32))
    return depth, np.stack(Rs), np.stack(Ts)


def test_voxgraph_pass_matches_jax():
    depth, Rs, Ts = _vox_frames()
    n = len(depth)
    eye = np.eye(3, dtype=np.float32)
    jsm = j_bench_configs._run_voxgraph_once(
        _recording(JSM), JDense, VOX_OPTS, K_DEP, n, depth, Rs, Ts, eye)
    tsm = bench_configs._run_voxgraph_once(
        _recording(TSM), TDense, VOX_OPTS, K_DEP, n,
        torch.as_tensor(depth.astype(np.int32)), Rs, Ts, eye, device=DEV)
    assert tsm.submaps == jsm.submaps and len(tsm.submaps) == 4
    assert tsm.frame_count == jsm.frame_count == n
    js = jsm.global_map.state
    ts = bridge.grid_state_to_numpy(tsm.global_map.state)
    for name in ("table", "block_coords", "num_blocks"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name), err_msg=name)
    np.testing.assert_array_equal(np.asarray(js.channels["TSDF_observed"]),
                                  ts.channels["TSDF_observed"])
    assert ts.channels["TSDF_observed"].any()
    np.testing.assert_allclose(np.asarray(js.channels["TSDF"]),
                               ts.channels["TSDF"], atol=2e-3)
    np.testing.assert_allclose(np.asarray(js.channels["W_TSDF"]),
                               ts.channels["W_TSDF"], rtol=2e-3, atol=1e-3)
    assert len(tsm.sent) == len(jsm.sent) == 3
    for a, b in zip(tsm.sent, jsm.sent):
        da, db = tdecode(zlib.decompress(a)), jdecode(zlib.decompress(b))
        assert da["frame_id"] == db["frame_id"]
        ia, ib = (np.asarray(d["indices"], np.int64) for d in (da, db))
        np.testing.assert_array_equal(ia[np.lexsort(ia.T)],
                                      ib[np.lexsort(ib.T)])


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

CLIS = {"bench": (bench, []),
        "bench_configs": (bench_configs, ["--quick"]),
        "bench_secondary": (bench_secondary, []),
        "compare_vs_reference": (compare_vs_reference, []),
        "gen_fixtures": (gen_fixtures, ["--frames", "2"]),
        "viewer_demo_scene": (viewer_demo_scene, ["--port", "0",
                                                  "--seconds", "0"])}


class _Asked(Exception):
    pass


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_needs_the_card_or_cpu(name, monkeypatch, tmp_path):
    """Without a card and without ``--cpu`` each CLI raises, naming the
    way out, before it renders or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(gen_fixtures, "FIXTURE_DIR", tmp_path)
    mod, argv = CLIS[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_defaults_to_the_card(name, monkeypatch, tmp_path):
    """With a card present and no ``--cpu``, each CLI resolves ``cuda``
    first; with ``--cpu``, the CPU."""
    monkeypatch.setattr(gen_fixtures, "FIXTURE_DIR", tmp_path)
    mod, argv = CLIS[name]
    for cpu, want in ((False, None), (True, "cpu")):
        asked = []

        def spy(device=None):
            asked.append(device)
            raise _Asked
        monkeypatch.setattr(device_mod, "resolve_device", spy)
        with pytest.raises(_Asked):
            mod.main(argv + (["--cpu"] if cpu else []))
        assert asked == [want]


def test_bench_configs_quick_cpu_rows(monkeypatch, tmp_path, capsys):
    """``--quick --cpu --only 1,2`` on 2 frames: the saved-map mesh and the
    octomap rows, and the table."""
    monkeypatch.setattr(gen_fixtures, "FIXTURE_DIR", tmp_path)
    rows = bench_configs.main(["--quick", "--cpu", "--frames", "2",
                               "--only", "1,2"])
    assert [r[0] for r in rows] == ["1 marching-cubes (saved map)",
                                    "2 octomap fusion (D435-like seq)"]
    assert all(r[2] > 0 for r in rows)
    out = capsys.readouterr().out
    assert "== BASELINE.json configs (cpu) ==" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "d435_synth_seq_2.npz", "ri_tsdf_equiv_2.npy"]


@pytest.mark.slow
def test_bench_configs_quick_cpu_all_five(monkeypatch, tmp_path, capsys):
    """``--quick --cpu --frames 6``: all five configurations' rows (several
    minutes on the CPU: config 3's 4096-block DenseESDF runs 36 frames)."""
    monkeypatch.setattr(gen_fixtures, "FIXTURE_DIR", tmp_path)
    rows = bench_configs.main(["--quick", "--cpu", "--frames", "6"])
    assert [r[0][0] for r in rows] == ["1", "2", "3", "3", "4", "4", "5"]
    assert all(r[2] > 0 for r in rows)
    assert "== BASELINE.json configs (cpu) ==" in capsys.readouterr().out


def test_viewer_demo_scene_starts_and_stops(capsys):
    viewer_demo_scene.main(["--cpu", "--port", "0", "--seconds", "0"])
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("[viewer-demo]")]
    assert len(line) == 1 and "serving http://127.0.0.1:" in line[0]
    assert "particles 4096" in line[0]
    assert int(line[0].split("mesh tris ")[1].split(",")[0]) > 0
