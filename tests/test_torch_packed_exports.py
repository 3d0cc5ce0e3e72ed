"""The models' exports through one packed buffer (``exports.pack_export``,
read by ``exports.unpack_export``) against the path they replace: each
unpacked output padded to its capacity on the host and x, y, z stacked
there (kept below as the plain reference, ``_padded``).

Every case checks the model's ``export_*`` arrays element for element
against that reference (shapes, dtypes and the padding's fill values
included), that they are C-contiguous, and that they alias nothing: not
the map's state, and not the arrays of a later export, so arrays held
from one call stay as they were after the map changes and exports again.
The cases run on the CPU; ``test_packed_exports_on_card`` repeats them on
the CUDA card, where the buffer comes back by one copy into pinned memory
and the surface and ESDF slice exports are graph replays from their
third call. This file imports no JAX, so the card's tests run on a
machine without it (``README.md``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from taichislam_tpu_torch.models.dense_esdf import DenseESDF  # noqa: E402
from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF  # noqa: E402
from taichislam_tpu_torch.models.octomap import Octomap  # noqa: E402
from taichislam_tpu_torch.ops import esdf as te  # noqa: E402
from taichislam_tpu_torch.ops import exports as tx  # noqa: E402
from taichislam_tpu_torch.ops import occupancy as to  # noqa: E402
from taichislam_tpu_torch.utils import profiling  # noqa: E402

K_DEP = np.array([40.0, 0, 32.0, 0, 40.0, 24.0, 0, 0, 1], np.float32)
K_COL = np.array([44.0, 0, 30.0, 0, 43.0, 25.0, 0, 0, 1], np.float32)
GRID = dict(map_scale=[6.4, 3.2], voxel_scale=0.1, max_ray_length=2.0,
            min_ray_length=0.3, max_blocks=256, max_submap_num=8,
            max_disp_particles=6000)
XYZ_FILL = -100000.0
SLICE_Z = 0.9


def _frame(f):
    rng = np.random.default_rng(f)
    jj, ii = np.meshgrid(np.arange(48), np.arange(64), indexing="ij")
    depth = (700 + 9 * f + 6.0 * ii + 3.0 * jj +
             rng.integers(0, 40, (48, 64))).astype(np.uint16)
    depth[rng.random((48, 64)) < 0.05] = 0
    tex = rng.integers(0, 255, (48, 64, 3)).astype(np.uint8)
    th = 0.3 * f
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]], np.float32)
    return R, np.array([0.07 * f, -0.05, 0.02], np.float32), depth, tex


def _padded(arrays, kept, fills):
    """The replaced host path: a float32 array of each device array's
    shape, the padding written on the host, the first ``kept`` rows read
    from the device."""
    out = []
    for a, fill in zip(arrays, fills):
        h = np.empty(tuple(a.shape), np.float32)
        h[kept:] = fill
        h[:kept] = a[:kept].cpu().numpy()
        out.append(h)
    return out


# -- the cases: a map, its export through the model, the reference ----------

def _tsdf_map(dev, textured=True):
    return DenseTSDF(**GRID, num_voxel_per_blk_axis=8,
                     texture_enabled=textured, disp_ceiling=1.5, device=dev)


def _esdf_map(dev):
    return DenseESDF(**GRID, num_voxel_per_blk_axis=8, texture_enabled=True,
                     disp_ceiling=1.5, max_esdf_sweeps=6, device=dev)


def _octo_map(dev):
    return Octomap(**GRID, min_occupy_thres=1, texture_enabled=True,
                   device=dev)


def _surface(m):
    m.cvt_TSDF_surface_to_voxels()
    return ({"xyz": m.export_TSDF_xyz, "values": m.export_TSDF,
             "color": m.export_color}, m.num_TSDF_particles)


def _surface_ref(m):
    cap = m.max_disp_particles
    x, y, z, col, tsdf, n = tx.tsdf_surface_export(
        m.cfg, cap, m._export_block_bucket(), m.state, *m._bases(),
        m.active_submap_id)
    n = int(n)
    x, y, z, col, tsdf = _padded((x, y, z, col, tsdf), n,
                                 (XYZ_FILL,) * 3 + (0.5, 0.0))
    return {"xyz": np.stack([x, y, z], axis=1), "values": tsdf,
            "color": col}, n


def _tsdf_slice(m):
    m.cvt_TSDF_to_voxels_slice(SLICE_Z)
    return ({"xyz": m.export_TSDF_xyz, "values": m.export_TSDF,
             "color": m.export_color}, m.num_TSDF_particles)


def _tsdf_slice_ref(m):
    x, y, zc, tsdf, col, n = tx.tsdf_slice_export(
        m.cfg, m.max_disp_particles, m._export_block_bucket(), m.state,
        *m._bases(), m.active_submap_id, SLICE_Z, 0.5)
    n = int(n)
    x, y, zc, tsdf, col = _padded((x, y, zc, tsdf, col), n,
                                  (XYZ_FILL,) * 3 + (0.0, 0.5))
    return {"xyz": np.stack([x, y, zc], axis=1), "values": tsdf,
            "color": col}, n


def _esdf_slice(m):
    m.cvt_ESDF_to_voxels_slice(SLICE_Z)
    return ({"xyz": m.export_ESDF_xyz, "values": m.export_ESDF,
             "color": m.export_color}, m.num_export_ESDF_particles)


def _esdf_slice_ref(m):
    x, y, zc, e, col, n = te.esdf_slice_export(
        m.cfg, m.max_disp_particles, m._export_block_bucket(), m.state,
        m.esdf, m.esdf_observed, *m._bases(), m.active_submap_id, SLICE_Z,
        0.5)
    n = int(n)
    x, y, zc, e, col = _padded((x, y, zc, e, col), n,
                               (XYZ_FILL,) * 3 + (0.0, 0.5))
    return {"xyz": np.stack([x, y, zc], axis=1), "values": e,
            "color": col}, n


def _occupy(m):
    m.cvt_occupy_to_voxels(0)
    return ({"xyz": m.export_x, "color": m.export_color},
            m.num_export_particles)


def _occupy_ref(m):
    cap = m.max_disp_particles
    bcap = min(tx.pow2_capacity(int(m.state.num_blocks) + 1, lo=64),
               m.cfg.max_blocks)
    x, y, z, col, n = to.occupy_export(
        m.cfg, cap, 0, bcap, m.state,
        m._tensor(m.submaps_base_R_np, np.float32),
        m._tensor(m.submaps_base_T_np, np.float32), m.active_submap_id)
    n = int(n)
    x, y, z, col = _padded((x, y, z, col), n, (XYZ_FILL,) * 3 + (0.5,))
    return {"xyz": np.stack([x, y, z], axis=1), "color": col}, n


# the ``_to`` variant appends after PREFILL rows of the caller's buffers
PREFILL, TO_CAP = 7, 2000


def _to_buffers():
    return (np.full((TO_CAP, 3), 3.0, np.float32),
            np.full((TO_CAP, 3), 0.25, np.float32))


def _surface_to(m):
    xyz, col = _to_buffers()
    n = m.cvt_TSDF_surface_to_voxels_to(PREFILL, TO_CAP, xyz, col)
    return {"xyz": xyz, "color": col}, n


def _surface_to_ref(m):
    x, y, z, c, _, kept = tx.tsdf_surface_export(
        m.cfg, TO_CAP, m._export_block_bucket(), m.state, *m._bases(),
        m.active_submap_id)
    kept = int(kept)
    x, y, z, c = _padded((x, y, z, c), kept, (XYZ_FILL,) * 3 + (0.5,))
    xyz, col = _to_buffers()
    copy = min(kept, TO_CAP - PREFILL)
    xyz[PREFILL:PREFILL + copy] = np.stack([x, y, z], axis=1)[:copy]
    col[PREFILL:PREFILL + copy] = c[:copy]
    return {"xyz": xyz, "color": col}, PREFILL + copy


CASES = {
    "surface_textured": (_tsdf_map, _surface, _surface_ref),
    "surface_plain": (lambda d: _tsdf_map(d, textured=False), _surface,
                      _surface_ref),
    "tsdf_slice": (_tsdf_map, _tsdf_slice, _tsdf_slice_ref),
    "esdf_slice": (_esdf_map, _esdf_slice, _esdf_slice_ref),
    "occupy": (_octo_map, _occupy, _occupy_ref),
    "surface_to": (_tsdf_map, _surface_to, _surface_to_ref),
}
FILLS = {"xyz": XYZ_FILL, "values": 0.0, "color": 0.5}
SITES = {"surface_textured": "surface_packed",
         "surface_plain": "surface_packed", "tsdf_slice": "tsdf_slice_packed",
         "esdf_slice": "esdf_slice_packed", "occupy": "occupy_packed",
         "surface_to": "surface_packed"}


def _state_arrays(m):
    """The map's state tensors as numpy arrays (CPU maps)."""
    st = m.state
    ts = [getattr(st, f) for f in st._fields if f != "channels"]
    ts += list(st.channels.values())
    ts += [getattr(m, n) for n in ("esdf", "esdf_fixed", "esdf_observed")
           if isinstance(getattr(m, n, None), torch.Tensor)]
    return [t.numpy() for t in ts]


def _check(name, dev):
    make, export, reference = CASES[name]
    m = make(dev)
    m.set_dep_camera_intrinsic(K_DEP)
    m.set_color_camera_intrinsic(K_COL)
    for f in range(2):
        m.recast_depth_to_map(*_frame(f))
    before = profiling.counts().get("host_read/export." + SITES[name], 0)
    got, n = export(m)
    assert profiling.counts()["host_read/export." + SITES[name]] == \
        before + 1
    want, n_want = reference(m)
    assert n == n_want > 50
    assert got.keys() == want.keys()
    for k, a in got.items():
        assert a.dtype == np.float32 and a.shape == want[k].shape, k
        assert a.flags.c_contiguous, k
        np.testing.assert_array_equal(a, want[k], err_msg=k)
        if name != "surface_to":
            assert (a[n:] == FILLS[k]).all(), k
    held = {k: a.copy() for k, a in got.items()}
    if dev.type == "cpu":
        for k, a in got.items():
            assert not any(np.may_share_memory(a, s)
                           for s in _state_arrays(m)), k
    # the map changes, the model exports again (twice: on the card the
    # surface and ESDF slice units capture at the second call and replay
    # from the third)
    m.recast_depth_to_map(*_frame(2))
    for _ in range(2):
        again, n2 = export(m)
    want2, n2_want = reference(m)
    assert n2 == n2_want
    assert any(not np.array_equal(again[k], held[k]) for k in held)
    for k, a in again.items():
        np.testing.assert_array_equal(a, want2[k], err_msg=k)
        np.testing.assert_array_equal(got[k], held[k], err_msg=k)
        assert not any(np.may_share_memory(a, b) for b in got.values()), k


@pytest.mark.parametrize("name", list(CASES))
def test_packed_exports_match_padded_host_path(name):
    _check(name, torch.device("cpu"))


@pytest.mark.card
@pytest.mark.parametrize("name", list(CASES))
def test_packed_exports_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card: the pinned read and the graph "
                    "replays run only there")
    _check(name, torch.device("cuda"))


def test_pack_export_layout():
    """The buffer's layout: xyz row-major, the values, the color, then the
    count's int32 bits; without values the color follows xyz."""
    cap = 4
    x, y, z = (torch.arange(cap, dtype=torch.float32) + 10 * a
               for a in range(3))
    v = torch.arange(cap, dtype=torch.float32) - 5
    col = torch.arange(3 * cap, dtype=torch.float32).reshape(cap, 3) / 16
    kept = torch.tensor(3, dtype=torch.int32)
    buf = tx.pack_export((x, y, z), v, col, kept)
    assert buf.dtype == torch.float32 and buf.shape == (7 * cap + 1,)
    np.testing.assert_array_equal(buf[:3 * cap].numpy(),
                                  torch.stack([x, y, z], -1).reshape(-1))
    xyz, vals, c, n = tx.unpack_export(buf, cap, True, "test.packed")
    assert n == 3
    np.testing.assert_array_equal(xyz, torch.stack([x, y, z], -1))
    np.testing.assert_array_equal(vals, v)
    np.testing.assert_array_equal(c, col)
    xyz, vals, c, n = tx.unpack_export(
        tx.pack_export((x, y, z), None, col, kept), cap, False, "test.packed")
    assert vals is None and n == 3
    np.testing.assert_array_equal(c, col)
