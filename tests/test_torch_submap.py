"""SubmapMapping (models/submap_mapping.py): the PyTorch port against the
JAX package, and the port's own async, retry and wire guarantees.

Both packages drive the same frames with the options of
``tests/test_submap.py``. The JAX models take their XLA paths on the CPU,
the port its K1 twin, so global maps compare to the fusion bounds of
``tests/test_pallas_accum.py``: block tables exact, TSDF atol 2e-3, W rtol
2e-3 / atol 1e-3. Wire payloads are compared decoded, never as bytes
(``np.savez`` stamps the time into its zip entries).
"""

import io
import time
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from taichislam_tpu.models.dense_tsdf import DenseTSDF as JDense  # noqa: E402,E501
from taichislam_tpu.models.octomap import Octomap as JOcto  # noqa: E402
from taichislam_tpu.models.submap_mapping import \
    SubmapMapping as JSM  # noqa: E402
from taichislam_tpu.models.submap_mapping import \
    _decode_submap_npz as jdecode  # noqa: E402
from taichislam_tpu.models.submap_mapping import \
    _decode_traj_npz as jtraj  # noqa: E402
from taichislam_tpu.utils.comm import (CHANNEL_SUBMAP, CHANNEL_TRAJ,  # noqa: E402,E501
                                       LoopbackTransport, SLAMComm)
from taichislam_tpu_torch import bridge  # noqa: E402
from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF as TDense  # noqa: E402,E501
from taichislam_tpu_torch.models.dense_tsdf import _block_cap  # noqa: E402,E501
from taichislam_tpu_torch.models.octomap import Octomap as TOcto  # noqa: E402
from taichislam_tpu_torch.ops.fusion import splat_contributions  # noqa: E402,E501
from taichislam_tpu_torch.models.submap_mapping import \
    SubmapMapping as TSM  # noqa: E402
from taichislam_tpu_torch.models.submap_mapping import \
    _decode_submap_npz as tdecode  # noqa: E402
from taichislam_tpu_torch.utils import profiling  # noqa: E402
from submap_wire import (assert_same_payloads, decoded,  # noqa: E402
                         record_inline_payloads)

K_DEP = np.array([40.0, 0, 32.0, 0, 40.0, 24.0, 0, 0, 1], np.float32)
SUB_OPTS = dict(map_scale=[6.4, 6.4], voxel_scale=0.1,
                num_voxel_per_blk_axis=8, max_ray_length=2.0,
                min_ray_length=0.3, max_blocks=512, max_bins=8192,
                max_disp_particles=65536, max_submap_num=16,
                max_fuse_voxels=1 << 15)
GLOB_OPTS = dict(map_scale=[12.8, 6.4], voxel_scale=0.1,
                 num_voxel_per_blk_axis=8, max_blocks=1024,
                 max_disp_particles=65536, is_global_map=True,
                 max_fuse_voxels=1 << 15)
EYE = np.eye(3, dtype=np.float32)
EXT = (EYE, np.zeros(3, np.float32))

# every port model here runs on the CPU, asked for explicitly (the models
# default to the CUDA card)
DEV = torch.device("cpu")


def depth_frame(t=0):
    jj, ii = np.meshgrid(np.arange(48), np.arange(64), indexing="ij")
    return (1000 + 20 * t + 4.0 * ii + 2.0 * jj).astype(np.uint16)


def pose(t):
    return EYE, np.array([0.1 * t, 0, 0], np.float32)


def make(cls, dense=None, keyframe_step=2, **kw):
    if cls is TSM:
        kw["device"] = DEV
    sm = cls(dense or (TDense if cls is TSM else JDense),
             keyframe_step=keyframe_step, sub_opts=SUB_OPTS,
             global_opts=GLOB_OPTS, **kw)
    sm.set_dep_camera_intrinsic(K_DEP)
    return sm


def drive(sms, frames):
    for t in frames:
        for sm in sms:
            sm.recast_depth_to_map_by_frame(t, True, pose(t), EXT,
                                            depth_frame(t), None)


def global_dict(sm):
    idx, tsdf, w, _, _ = sm.global_map.to_numpy()
    return {tuple(i): (t, ww) for i, t, ww in zip(idx, tsdf, w)}


def assert_same_dicts(a, b, **tol):
    assert a.keys() == b.keys() and len(a) > 0
    for k in b:
        np.testing.assert_allclose(a[k], b[k], **tol)


def assert_same_global(jsm, tsm):
    """Global maps of the two packages: tables exact, fusion tolerances."""
    js, ts = jsm.global_map.state, bridge.grid_state_to_numpy(
        tsm.global_map.state)
    for name in ("table", "block_coords", "num_blocks"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name), err_msg=name)
    np.testing.assert_array_equal(np.asarray(js.channels["TSDF_observed"]),
                                  ts.channels["TSDF_observed"])
    np.testing.assert_allclose(np.asarray(js.channels["TSDF"]),
                               ts.channels["TSDF"], atol=2e-3)
    np.testing.assert_allclose(np.asarray(js.channels["W_TSDF"]),
                               ts.channels["W_TSDF"], rtol=2e-3, atol=1e-3)


@pytest.fixture(scope="module")
def driven():
    jsm, tsm = make(JSM), make(TSM)
    drive((jsm, tsm), range(5))
    return jsm, tsm


def test_creation_policy_matches_jax(driven):
    jsm, tsm = driven
    # keyframe_step=2: new submaps on frames 0, 2, 4
    assert tsm.submaps == jsm.submaps == {0: 0, 2: 1, 4: 2}
    assert tsm.submap_collection.active_submap_id == 2


def test_global_map_after_five_frames_matches_jax(driven):
    jsm, tsm = driven
    assert_same_global(jsm, tsm)
    assert tsm.global_map.count_active() == jsm.global_map.count_active() > 0
    for sm in (jsm, tsm):
        sm.set_exporting_global()
        sm.cvt_TSDF_surface_to_voxels()
    assert tsm.num_TSDF_particles == jsm.num_TSDF_particles > 0


def test_pgo_reposing_matches_jax():
    jsm, tsm = make(JSM), make(TSM)
    drive((jsm, tsm), range(5))
    shifted = {fid: (EYE, np.array([1.0, 0, 0], np.float32))
               for fid in tsm.submaps}
    trajs = []
    tsm.traj_send_handle = trajs.append
    for sm in (jsm, tsm):
        sm.set_frame_poses(shifted)
        sm.local_to_global()
    for sid in tsm.submaps.values():
        np.testing.assert_allclose(tsm.global_map.submaps_base_T_np[sid],
                                   [1.0, 0, 0])
    assert_same_global(jsm, tsm)
    # the trajectory went out once, with the re-posed keyframes
    assert len(trajs) == 1
    assert sorted(jtraj(zlib.decompress(trajs[0]))) == [0, 2, 4]


def test_convert_by_pgo_chains_ego_motion():
    out = []
    for cls in (JSM, TSM):
        sm = make(cls, keyframe_step=100)
        sm.ego_motion_poses[0] = (EYE, np.zeros(3, np.float32))
        sm.pgo_poses[0] = (EYE, np.array([5.0, 0, 0], np.float32))
        sm.last_frame_id = 0
        R, T = sm.convert_by_pgo(1, EYE, np.array([0.5, 0, 0], np.float32))
        out.append(T)
    np.testing.assert_allclose(out[1], [5.5, 0, 0], atol=1e-6)
    np.testing.assert_array_equal(out[0], out[1])


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_two_drone_exchange_across_packages(direction):
    """Drone A sends its first submap over a loopback link; drone B of the
    other package ingests it. The payload decodes to the same arrays as
    the receiving package's own, and B's remote slot and global map equal
    B' fed with that own payload."""
    send_cls, recv_cls = (TSM, JSM) if direction == "port_to_jax" else \
        (JSM, TSM)
    decode = jdecode if recv_cls is JSM else tdecode
    hub = LoopbackTransport.Hub()
    comm_a = SLAMComm(0, transport=LoopbackTransport(hub))
    comm_b = SLAMComm(1, transport=LoopbackTransport(hub))
    a, a_own, b, b_own = (make(send_cls), make(recv_cls), make(recv_cls),
                          make(recv_cls))
    a_sent, own = [], []

    def send(buf):
        a_sent.append(buf)
        comm_a.publishBuffer(buf, CHANNEL_SUBMAP)

    a.map_send_handle = send
    a.traj_send_handle = lambda buf: comm_a.publishBuffer(buf, CHANNEL_TRAJ)
    a_own.map_send_handle = own.append
    comm_b.on_submap = b.input_remote_submap
    comm_b.on_traj = b.input_remote_traj
    drive((a, a_own), range(3))   # the submap goes out at frame 2
    comm_b.handle()
    assert len(a_sent) == len(own) == 1
    b_own.input_remote_submap(own[0])
    for m in (b, b_own):
        col = m.submap_collection
        assert col.remote_submap_num == 1
        assert m.submaps == {0: col.max_submap_num - 1}
    # both payloads, decoded by the receiving package
    got_a, want = (decode(zlib.decompress(x)) for x in (a_sent[0], own[0]))
    assert got_a["frame_id"] == want["frame_id"] == 0
    order_g = np.lexsort(np.asarray(got_a["indices"], np.int64).T)
    order_w = np.lexsort(np.asarray(want["indices"], np.int64).T)
    np.testing.assert_array_equal(np.asarray(got_a["indices"])[order_g],
                                  np.asarray(want["indices"])[order_w])
    for key, tol in (("TSDF", 2e-3), ("W_TSDF", 2e-2), ("occupy", 0)):
        np.testing.assert_allclose(
            np.asarray(got_a[key], np.float32)[order_g],
            np.asarray(want[key], np.float32)[order_w], atol=tol, rtol=2e-3)
    np.testing.assert_allclose(got_a["pose"][1], want["pose"][1])
    # B's global map from the other package's payload equals B'
    bs, bo = b.global_map, b_own.global_map
    assert bs.count_active() == bo.count_active() > 0
    assert_same_dicts(global_dict(b), global_dict(b_own), atol=2e-3,
                      rtol=2e-2)


def test_incremental_fuse_matches_full():
    """incremental_fuse: one splat per finished submap equals reset +
    refuse-all at every boundary, and a PGO update falls back to the full
    refuse; the full path also equals the JAX package's."""
    inc, full, jfull = (make(TSM, incremental_fuse=True), make(TSM),
                        make(JSM))
    drive((inc, full, jfull), range(6))
    assert_same_dicts(global_dict(inc), global_dict(full), atol=1e-4)
    assert_same_global(jfull, full)
    shifted = {fid: (EYE, np.array([0.5, 0, 0], np.float32))
               for fid in full.submaps}
    for sm in (inc, full, jfull):
        sm.set_frame_poses(shifted)
    assert inc._fusion_dirty
    drive((inc, full, jfull), range(6, 8))
    assert not inc._fusion_dirty
    assert_same_dicts(global_dict(inc), global_dict(full), atol=1e-4)
    assert_same_global(jfull, full)


def _decoded(bufs):
    return [tdecode(zlib.decompress(b)) for b in bufs]


def test_async_finalize_matches_sync_with_overflow():
    """async_finalize (wire on the worker pool) equals the synchronous
    incremental path after sync(), also when a touched bucket of 1 forces
    every boundary's fuse to grow and reduce again."""
    sent = {True: [], False: []}
    sms = {}
    for async_ in (True, False):
        sms[async_] = make(TSM, incremental_fuse=True, async_finalize=async_)
        sms[async_].map_send_handle = sent[async_].append
    sms[True].global_map._fuse_touched_bucket = 1
    drive(sms.values(), range(6))
    for sm in sms.values():
        sm.flush()
    assert sms[True].global_map.last_fuse["attempts"] >= 1
    assert sms[True].global_map._fuse_touched_bucket > 1
    assert_same_dicts(global_dict(sms[True]), global_dict(sms[False]),
                      atol=1e-4)
    subs_a, subs_s = _decoded(sent[True]), _decoded(sent[False])
    assert len(subs_a) == len(subs_s) == 3    # 2 finalized + 1 flush
    for da, ds in zip(subs_a, subs_s):
        assert da["frame_id"] == ds["frame_id"]
        assert da.keys() == ds.keys()
        order_a = np.lexsort(np.asarray(da["indices"], np.int64).T)
        order_s = np.lexsort(np.asarray(ds["indices"], np.int64).T)
        for key in ("indices", "TSDF", "W_TSDF", "occupy"):
            np.testing.assert_array_equal(np.asarray(da[key])[order_a],
                                          np.asarray(ds[key])[order_s])


def test_retry_after_overflow_equals_run_without_overflow():
    """A fuse whose first attempts drop touched tiles and source blocks
    grows and reduces again before anything is written: the map equals a
    fuse that fitted at once (weighted fusion is not idempotent, so a
    retry on top of a failed attempt would count weights twice)."""
    def rotz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)

    sub = TDense(**dict(SUB_OPTS, num_voxel_per_blk_axis=4, max_blocks=1024),
                 device=DEV)
    sub.set_dep_camera_intrinsic(K_DEP)
    for t in range(6):
        sub.recast_depth_to_map(
            rotz(t * np.pi / 3),
            np.array([0.2 * (t % 3), 0.2 * (t % 2), 0.1 * t], np.float32),
            depth_frame(t), None)
    assert int(sub.state.num_blocks) > 128

    def glob():
        return TDense(**GLOB_OPTS, device=DEV)

    ref = glob()
    ref.fuse_submaps_incremental(sub, 0)
    assert ref.last_fuse["attempts"] == 1
    tight = glob()
    tight._fuse_touched_bucket = 1
    tight.fuse_submaps_incremental(sub, 0, sub_bcap=64, defer_verdict=True)
    assert tight.last_fuse["attempts"] > 2 and tight.last_fuse["bcap"] > 64
    # the forced source drop grows the cap by the refuse's one cap rule
    over = int(splat_contributions(sub.cfg, tight.cfg, 64, sub.state,
                                   *tight._bases(), 0).dropped)
    assert over > 0 and tight.last_fuse["bcap"] == _block_cap(
        64 + over, sub.cfg.max_blocks)
    for k in ("fuse_dropped", "fuse_tiles_dropped"):
        assert int(tight.last_stats[k]) == 0
    a, b = global_dict_of(tight), global_dict_of(ref)
    assert a.keys() == b.keys() and len(a) > 0
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


def global_dict_of(m):
    idx, tsdf, w, _, _ = m.to_numpy()
    return {tuple(i): (t, ww) for i, t, ww in zip(idx, tsdf, w)}


def test_async_fallback_send_preserves_fifo_order():
    """A boundary that falls back to the synchronous finalize (PGO marked
    the fusion dirty) must not overtake queued async sends."""
    sent = []
    sm = make(TSM, incremental_fuse=True, async_finalize=True)
    sm.map_send_handle = sent.append
    orig = sm._wire_prepare

    def slow_prepare(*a, **kw):
        time.sleep(2.0)
        return orig(*a, **kw)

    sm._wire_prepare = slow_prepare
    for t in range(4):   # the boundary at t=2 sends submap 0 async
        drive((sm,), [t])
        if t == 2:
            sm.set_frame_poses({0: (EYE, np.array([0.3, 0, 0], np.float32))})
    assert sm._fusion_dirty
    drive((sm,), [4])
    sm.flush()
    ids = [int(d["frame_id"]) for d in _decoded(sent)]
    assert ids == sorted(ids) == [0, 2, 4]


def test_async_wire_failure_surfaces_at_sync():
    sm = make(TSM, incremental_fuse=True, async_finalize=True)

    def broken_send(buf):
        raise IOError("transport down")

    sm.map_send_handle = broken_send
    drive((sm,), range(3))
    with pytest.raises(RuntimeError, match="async submap send"):
        sm.sync()
    sm.sync()   # consumed: no second raise


@pytest.mark.parametrize("wire_format", ["npz", "pickle"])
def test_boundary_wire_equals_inline_export(wire_format):
    """Each boundary's read, encode and publish run on the wire pool beside
    the fuse: over 3 boundaries the published payloads decode to the arrays
    of an inline export_submap() + _encode of the same submap, in boundary
    order, each published before its boundary's call returns; and
    ``submap/wire_overlapped`` counts every boundary."""
    sent, at_return = [], []
    sm = make(TSM, wire_format=wire_format)
    sm.map_send_handle = sent.append
    encode = sm._encode

    def slow_encode(obj):           # outlasts the fuse: the join must wait
        time.sleep(0.3)
        return encode(obj)
    sm._encode = slow_encode
    want = record_inline_payloads(sm)
    before = profiling.counts().get("submap/wire_overlapped", 0)
    for t in range(7):                  # boundaries at frames 2, 4 and 6
        drive((sm,), [t])
        at_return.append(len(sent))
    assert at_return == [0, 0, 1, 1, 2, 2, 3]
    assert profiling.counts()["submap/wire_overlapped"] - before == 3
    assert_same_payloads(sm, sent, want)
    assert [int(d["frame_id"]) for d in decoded(sm, sent)] == [0, 2, 4]


def test_boundary_wire_failure_raises_from_its_boundary():
    """A pool task that raises makes its boundary's call raise, once the
    next submap stands; the sender lives on, and later boundaries publish
    in order."""
    sent = []
    sm = make(TSM)
    sm.map_send_handle = sent.append
    real = sm._encode

    def encode(obj):
        if obj["frame_id"] == 2:
            raise ValueError("encoder down")
        return real(obj)
    sm._encode = encode
    drive((sm,), range(4))              # the boundary at 2 sends submap 0
    with pytest.raises(RuntimeError, match="submap send") as err:
        drive((sm,), [4])               # submap 2's send fails
    assert isinstance(err.value.__cause__, ValueError)
    assert sm.submaps == {0: 0, 2: 1, 4: 2}
    assert sm.submap_collection.active_submap_id == 2
    drive((sm,), range(5, 9))
    ids = [int(d["frame_id"]) for d in decoded(sm, sent)]
    assert ids[0] == 0 and 2 not in ids and len(ids) == 3
    assert ids == sorted(ids)
    assert sm._wire_thread.is_alive()
    sm.sync()                           # nothing left to raise


def test_submap_export_gathers_its_own_blocks():
    """export_submap sizes its gather by the active submap's own blocks,
    read with its voxel count in one read: the same dict as a gather at the
    whole collection's block cap."""
    from taichislam_tpu_torch.ops import exports as exports_ops
    sm = make(TSM)
    drive((sm,), range(5))
    col = sm.submap_collection
    sid = col.active_submap_id
    blocks = int(exports_ops.count_active_blocks(col.cfg, col.state, sid))
    whole = col._export_block_bucket()
    assert 0 < exports_ops.pow2_capacity(blocks + 1, lo=64) < whole
    cap = exports_ops.pow2_capacity(col.count_active())
    buf = exports_ops.sparse_gather_packed(col.cfg, cap, whole, col.state,
                                           sid)
    want = col._submap_dict(*exports_ops.unpack_sparse_delivery(
        buf, cap, col.enable_texture)[:5])
    before = profiling.counts()
    got = col.export_submap()
    reads = {k: v - before.get(k, 0) for k, v in profiling.counts().items()
             if k.startswith("host_read/") and v != before.get(k, 0)}
    assert reads == {"host_read/tsdf.count_active": 1,
                     "host_read/exports.sparse_buffer": 1}
    assert got.keys() == want.keys() and len(got["TSDF"]) > 0
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pickle_payload_dropped_under_npz():
    sm = make(TSM)
    f = io.BytesIO()
    np.save(f, {"indices": np.zeros((1, 3), np.int16), "frame_id": 7,
                "pose": (EYE, np.zeros(3))})
    sm.input_remote_submap(zlib.compress(f.getvalue()))
    assert sm.submap_collection.remote_submap_num == 0 and not sm.submaps
    sm.input_remote_submap(zlib.compress(b"not a payload"))
    assert sm.submap_collection.remote_submap_num == 0


def test_decompression_bomb_guard():
    sm = make(TSM)
    sm.MAX_WIRE_PLAINTEXT = 4096
    with pytest.raises(ValueError, match="bomb guard"):
        sm.input_remote_submap(zlib.compress(b"\0" * 100000))


def test_submap_registry_copy_starts_port_from_jax_state():
    """bridge.copy_submap_registry: a port SubmapMapping continued from a
    JAX one's state equals the JAX one continued."""
    jsm, tsm = make(JSM), make(TSM)
    drive((jsm,), range(3))
    bridge.copy_submap_registry(jsm, tsm)
    assert tsm.submaps == jsm.submaps and tsm.frame_count == 3
    np.testing.assert_array_equal(tsm.global_map.submaps_base_T_np,
                                  jsm.global_map.submaps_base_T_np)
    assert tsm.submap_collection.active_submap_id == 1
    drive((jsm, tsm), range(3, 5))
    assert tsm.submaps == jsm.submaps
    assert_same_global(jsm, tsm)


OCTO_SUB = dict(map_scale=[6.4, 3.2], voxel_scale=0.1, max_blocks=256,
                max_submap_num=8, min_occupy_thres=0,
                max_disp_particles=65536)
OCTO_GLOB = dict(map_scale=[12.8, 3.2], voxel_scale=0.1, max_blocks=512,
                 max_disp_particles=65536, min_occupy_thres=0,
                 is_global_map=True)


def _octo_pcls(n=6):
    rng = np.random.default_rng(0)
    return [rng.uniform(0.4, 1.4, size=(400, 3)).astype(np.float32)
            for _ in range(n)]


def _octo(cls, **kw):
    if cls is TSM:
        kw["device"] = DEV
    sm = cls(JOcto if cls is JSM else TOcto, keyframe_step=2,
             sub_opts=OCTO_SUB, global_opts=OCTO_GLOB, **kw)
    sm.set_dep_camera_intrinsic(K_DEP)
    return sm


def test_octomap_submaps_match_jax():
    jsm, tsm = _octo(JSM), _octo(TSM)
    for t, pcl in enumerate(_octo_pcls(3)):
        for sm in (jsm, tsm):
            sm.recast_pcl_to_map_by_frame(t, True, pose(t), EXT, pcl,
                                          np.zeros((400, 3), np.float32))
    assert len(tsm.submaps) == 2
    for sm in (jsm, tsm):
        sm.set_exporting_global()
        sm.cvt_occupy_to_voxels(0)
    assert tsm.num_export_particles == jsm.num_export_particles > 0
    np.testing.assert_array_equal(jsm.export_x, tsm.export_x)
    for k, v in jsm.global_map.state.channels.items():
        np.testing.assert_array_equal(
            np.asarray(v), tsm.global_map.state.channels[k].numpy())


def test_octomap_async_finalize_matches_sync():
    sent = {True: [], False: []}
    sms = {}
    for async_ in (True, False):
        sms[async_] = _octo(TSM, async_finalize=async_)
        sms[async_].map_send_handle = sent[async_].append
    assert sms[True].async_finalize and sms[True].incremental_fuse
    for t, pcl in enumerate(_octo_pcls()):
        for sm in sms.values():
            sm.recast_pcl_to_map_by_frame(t, True, pose(t), EXT, pcl,
                                          np.zeros((400, 3), np.float32))
    sms[True].sync()
    for k in ("table", "block_coords", "num_blocks"):
        assert torch.equal(getattr(sms[True].global_map.state, k),
                           getattr(sms[False].global_map.state, k)), k
    assert torch.equal(sms[True].global_map.state.channels["occupy"],
                       sms[False].global_map.state.channels["occupy"])
    assert len(sent[True]) == len(sent[False]) == 2
    subs = _decoded(sent[True])
    assert [s["frame_id"] for s in subs] == [0, 2]
    for a, b in zip(subs, _decoded(sent[False])):
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["pose"][1], b["pose"][1])


def _node_opts():
    """node/core.py's option builders at a small size: get_sdf_opts for the
    global map, get_submap_opts for the collection. Cut: map 6.4 x 3.2 m
    at 10 cm, V = 8, max_ray 2.0 m (the node: 100 x 10 m, 5 cm, V = 16,
    5.1 m)."""
    glob = dict(texture_enabled=True, max_disp_particles=1024 * 1024,
                map_scale=[6.4, 3.2], voxel_scale=0.1, max_ray_length=2.0,
                min_ray_length=0.3, disp_ceiling=1.8, disp_floor=-0.3,
                color_same_proj=False, num_voxel_per_blk_axis=8)
    return glob, dict(glob, max_disp_particles=100000)


def test_node_submap_path_matches_jax():
    """The launch files' path (enable_submap, mapping_type=tsdf), built as
    node/core.py builds it, on a small map: SubmapMapping(DenseTSDF) with
    the node's option builders, textured with the color reprojection, the
    mesher on the global map; 6 synthetic orbit frames, keyframe_step=2.
    The JAX models run their K1 paths in interpret mode."""
    import dataclasses
    from taichislam_tpu.models.mesher import MarchingCubeMesher as JMesher
    from taichislam_tpu_torch.models.mesher import \
        MarchingCubeMesher as TMesher
    from taichislam_tpu_torch.utils.synthetic_scene import (D435_K,
                                                           orbit_sequence)
    K = (D435_K * np.float32(0.1)).astype(np.float32)
    K[8] = 1.0
    depth, Rs, Ts, _ = orbit_sequence(n_frames=6, h=48, w=64, K=K)
    rng = np.random.default_rng(21)
    texs = [rng.integers(0, 255, (48, 64, 3)).astype(np.uint8)
            for _ in range(6)]
    glob, sub = _node_opts()
    jsm = JSM(JDense, global_opts=glob, sub_opts=sub, keyframe_step=2)
    tsm = TSM(TDense, global_opts=glob, sub_opts=sub, keyframe_step=2,
              device=DEV)
    for m in (jsm.global_map, jsm.submap_collection):
        m.cfg = dataclasses.replace(m.cfg, pallas_accum="on")
    meshers = (JMesher(jsm.global_map, 100000, tsdf_surface_thres=0.5),
               TMesher(tsm.global_map, 100000, tsdf_surface_thres=0.5))
    tris = []
    for sm in (jsm, tsm):
        sm.set_color_camera_intrinsic(K)
        sm.set_dep_camera_intrinsic(K)
    for f in range(6):
        for sm in (jsm, tsm):
            sm.recast_depth_to_map_by_frame(f, True, (Rs[f], Ts[f]), EXT,
                                            depth[f], texs[f])
        for me in meshers:
            me.generate_mesh(1)
        tris.append(tuple(me.num_facelets for me in meshers))
    assert tsm.submaps == jsm.submaps == {0: 0, 2: 1, 4: 2}
    assert_same_global(jsm, tsm)
    np.testing.assert_allclose(
        np.asarray(jsm.global_map.state.channels["color"]),
        tsm.global_map.state.channels["color"].numpy(), atol=2e-3)
    assert all(a == b for a, b in tris) and tris[-1][0] > 100, tris


def test_async_wire_pool_under_contention():
    """Many boundaries through the 3-thread wire pool with a short switch
    interval: sends stay in boundary order, no payload is truncated, and
    the grow-only capacity prediction covers every submap sent (a lost
    update of the shared prediction would leave it below one)."""
    import sys
    sent = []
    sm = make(TSM, keyframe_step=1, async_finalize=True)
    sm.map_send_handle = sent.append
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        drive((sm,), range(10))
        sm.sync()
    finally:
        sys.setswitchinterval(old)
    assert [d["frame_id"] for d in _decoded(sent)] == list(range(9))
    for buf in sent:
        with np.load(io.BytesIO(zlib.decompress(buf))) as z:
            head = z["packed_bitmap"][:16].view(np.int32)
            caps = (int(z["lane_cap"]), int(z["block_cap"]))
        total_b, total_v = int(head[1]), int(head[3])
        assert total_b <= caps[1] and total_v <= caps[0]
        want = sm._predict_caps(total_b, total_v)
        assert sm._wire_caps[0] >= want[0] and sm._wire_caps[1] >= want[1]
    assert sm._wire_thread.is_alive()
