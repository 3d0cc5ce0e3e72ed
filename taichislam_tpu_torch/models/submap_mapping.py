"""SubmapMapping: voxgraph-style submap collection and global map.

Counterpart of the JAX package's ``models/submap_mapping.py``, over the PyTorch
``DenseTSDF`` and ``Octomap``: keyframe-driven submap creation, PGO pose
chaining (``convert_by_pgo``), local -> global fusion (full refuse, or
incremental splats of finished submaps), and the zlib-compressed submap and
trajectory wire. The wire payloads are those of the JAX package, so peers
running either package exchange submaps.

Trust boundary: the reference's wire is a zlib-compressed pickled
``np.save`` blob, and decoding it runs arbitrary code. This class sends
plain-array ``np.savez`` payloads (``wire_format="npz"``) and decodes them
with ``allow_pickle=False``; an inbound pickle payload is decoded only with
``wire_format="pickle"`` (reference peers on a trusted network) and dropped
otherwise.

At a keyframe boundary the finished submap's gather and its copy to the
host are queued on the device ahead of the global map's fuse; a worker
pool reads, encodes and compresses it, and one sender thread publishes it,
while the node's thread runs the fuse. The boundary waits for that publish
before it returns (``submap/wire_overlapped`` counts such boundaries), so
peers receive every submap in boundary order, within the boundary's call.
``async_finalize`` goes further: the compact submap gather is started on
the device and the boundary returns without waiting for the send. The
capacity verdict of the incremental fuse is read at the boundary itself
(one host read), not deferred.

Every encoded submap handed to the transport is counted, in bytes, under
``submap/wire_bytes`` (``utils/profiling.count``), by the thread that
hands it over: the sender, or the node's own for ``flush``.
"""

from __future__ import annotations

import io
import queue
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from taichislam_tpu_torch.models.base_map import resolve_device
from taichislam_tpu_torch.models.dense_tsdf import DenseTSDF, bin_bucket_for
from taichislam_tpu_torch.models.octomap import Octomap
from taichislam_tpu_torch.ops import exports as exports_ops
from taichislam_tpu_torch.utils import profiling
from taichislam_tpu_torch.utils.profiling import host_read

# the reference's default options of both maps
_MAP_DEFAULTS = {"voxel_scale": 0.05, "texture_enabled": False,
                 "min_ray_length": 0.3, "max_ray_length": 3.0,
                 "max_disp_particles": 1024 * 1024}
_TYPE_DEFAULTS = {DenseTSDF: {"num_voxel_per_blk_axis": 10},
                  Octomap: {"K": 2}}

# submap-dict scalar keys restored from 0-d arrays by the npz codec
_WIRE_SCALARS = {"voxel_scale": float, "texture_enabled": bool,
                 "num_voxel_per_blk_axis": int, "frame_id": int}


def _encode_submap_npz(obj) -> bytes:
    """Plain arrays only (np.savez, no pickle)."""
    flat = {}
    for k, v in obj.items():
        if k == "pose":
            flat["pose_R"] = np.asarray(v[0], np.float64)
            flat["pose_T"] = np.asarray(v[1], np.float64)
        else:
            flat[k] = np.asarray(v)
    f = io.BytesIO()
    np.savez(f, **flat)
    return f.getvalue()


def _decode_submap_npz(data: bytes) -> dict:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        obj = {k: z[k] for k in z.files}
    if "pose_R" in obj:
        obj["pose"] = (obj.pop("pose_R"), obj.pop("pose_T"))
    for k, typ in _WIRE_SCALARS.items():
        if k in obj and obj[k].ndim == 0:
            obj[k] = typ(obj[k].item())
    if "map_scale" in obj:
        obj["map_scale"] = np.asarray(obj["map_scale"]).tolist()
    if "packed_bitmap" in obj:
        # the compact schema of an async finalize: expand it into the
        # per-voxel submap dict
        buf = obj.pop("packed_bitmap")
        lane_cap = int(obj.pop("lane_cap"))
        blk_cap = int(obj.pop("block_cap"))
        idx, tsdf, w, occ, col, *_ = exports_ops.unpack_bitmap_packed(
            buf, lane_cap, blk_cap, obj["num_voxel_per_blk_axis"],
            obj["texture_enabled"])
        obj.update(indices=idx, TSDF=tsdf, W_TSDF=w, occupy=occ,
                   color=col if np.asarray(col).size else np.array([]))
    return obj


def _encode_traj_npz(traj: dict) -> bytes:
    ids = np.asarray(sorted(traj), np.int64)
    Rs = np.stack([np.asarray(traj[i][0], np.float64) for i in ids]) \
        if len(ids) else np.zeros((0, 3, 3))
    Ts = np.stack([np.asarray(traj[i][1], np.float64) for i in ids]) \
        if len(ids) else np.zeros((0, 3))
    f = io.BytesIO()
    np.savez(f, ids=ids, Rs=Rs, Ts=Ts)
    return f.getvalue()


def _decode_traj_npz(data: bytes) -> dict:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        ids, Rs, Ts = z["ids"], z["Rs"], z["Ts"]
    return {int(i): (R, T) for i, R, T in zip(ids, Rs, Ts)}


def _encode_pickle(obj) -> bytes:
    f = io.BytesIO()
    np.save(f, obj)
    return f.getvalue()


class SubmapMapping:
    def __init__(self, submap_type=DenseTSDF, keyframe_step=20, sub_opts={},
                 global_opts={}, autosave_path=None, wire_format="npz",
                 incremental_fuse=False, async_finalize=False, device=None):
        if wire_format not in ("npz", "pickle"):
            raise ValueError(f"wire_format: want npz or pickle, got "
                             f"{wire_format!r}")
        # async_finalize implies incremental_fuse (see the module docstring);
        # call sync() before reading the global map from outside or
        # asserting on sent wire traffic
        self.async_finalize = bool(async_finalize)
        self.incremental_fuse = bool(incremental_fuse) or self.async_finalize
        self._wire_caps = None        # (lane_cap, block_cap) prediction
        self._wire_caps_lock = threading.Lock()
        self._wire_q = None
        self._wire_thread = None
        self._wire_errors = []        # failed pool sends, raised at join
        # a PGO base-pose update marks the incremental global map stale:
        # the next fusion is the full reset + refuse-all
        self._fusion_dirty = False
        self._active_in_global = False
        self.device = resolve_device(device)
        self.sub_opts = dict(_MAP_DEFAULTS, map_scale=[10, 10],
                             max_submap_num=1000,
                             **_TYPE_DEFAULTS[submap_type])
        self.sub_opts.update(sub_opts)
        self.submaps = {}
        self.frame_count = 0
        self.keyframe_step = keyframe_step
        self.submap_type = submap_type
        self.exporting_global = False
        self.autosave_path = autosave_path
        self.wire_format = wire_format
        self.submap_collection = self.submap_type(**self.sub_opts,
                                                  device=self.device)
        self.global_map = self.create_globalmap(global_opts)
        if self.async_finalize and submap_type == DenseTSDF:
            # accepted as in the JAX package; the port settles every window
            # verdict before recast_depth_sequence returns
            self.submap_collection.sequence_verdict_async = True
        self.first_init = True
        self.set_exporting_global()
        self.ego_motion_poses = {}
        self.pgo_poses = {}
        self.last_frame_id = None
        self.active_submap_frame_id = 0
        self.enable_texture = self.global_map.enable_texture
        self.post_local_to_global_callback = None
        self.map_send_handle = lambda buf: None
        self.traj_send_handle = lambda buf: None

    def create_globalmap(self, global_opts={}):
        opts = dict(_MAP_DEFAULTS, map_scale=[100, 100], is_global_map=True,
                    max_submap_num=(1024 if self.submap_type == DenseTSDF
                                    else 1000),
                    **_TYPE_DEFAULTS[self.submap_type])
        opts.update(global_opts)
        return self.submap_type(**opts, device=self.device)

    # -- camera passthrough -------------------------------------------------
    def set_dep_camera_intrinsic(self, K):
        self.submap_collection.set_dep_camera_intrinsic(K)

    def set_color_camera_intrinsic(self, K):
        self.submap_collection.set_color_camera_intrinsic(K)

    # -- export switching ---------------------------------------------------
    def _trace_scalars(self):
        """The collection's device scalars for a traced frame's record."""
        return self.submap_collection._trace_scalars()

    def set_exporting_global(self):
        self.exporting_global = True
        self.set_export_submap(self.global_map)

    def set_exporting_local(self):
        self.exporting_global = False
        self.set_export_submap(self.submap_collection)

    def set_export_submap(self, new_submap):
        self.export_map = new_submap

    @property
    def export_color(self):
        return self.export_map.export_color

    @property
    def export_TSDF_xyz(self):
        return self.export_map.export_TSDF_xyz

    @property
    def num_TSDF_particles(self):
        return self.export_map.num_TSDF_particles

    @property
    def export_x(self):
        return self.export_map.export_x

    @property
    def num_export_particles(self):
        return self.export_map.num_export_particles

    # -- PGO ----------------------------------------------------------------
    def set_frame_poses(self, frame_poses, from_remote=False):
        self.pgo_poses.update(frame_poses)
        used_poses = {}
        for frame_id in frame_poses:
            if (self.last_frame_id is None or frame_id > self.last_frame_id) \
                    and frame_id in self.ego_motion_poses:
                self.last_frame_id = frame_id
            if frame_id in self.submaps:
                R, T = frame_poses[frame_id]
                # only the global map's base pose moves with PGO (the
                # collection keeps its frame)
                self.global_map.set_base_pose_submap(self.submaps[frame_id],
                                                     R, T)
                used_poses[frame_id] = frame_poses[frame_id]
                # fused submaps moved: stale until the next full refuse
                self._fusion_dirty = True
        if not from_remote:
            self.send_traj(used_poses)

    def convert_by_pgo(self, frame_id, R, T):
        self.ego_motion_poses[frame_id] = (R, T)
        if self.last_frame_id is not None:
            last_ego_R, last_ego_T = self.ego_motion_poses[self.last_frame_id]
            last_pgo_R, last_pgo_T = self.pgo_poses[self.last_frame_id]
            R = last_pgo_R @ last_ego_R.T @ R
            T = last_pgo_R @ last_ego_R.T @ (T - last_ego_T) + last_pgo_T
        return R, T

    # -- submap lifecycle ---------------------------------------------------
    def need_create_new_submap(self, is_keyframe, R, T):
        if self.frame_count == 0:
            return True
        if not is_keyframe:
            return False
        return self.frame_count % self.keyframe_step == 0

    def _finalize_active_submap(self):
        """Ship the finished submap to peers, advance the collection to a
        fresh slot, and bring the global map up to date. Under the span
        ``submap.finalize`` (``create_new_submap``): ``submap.export`` (the
        gather and its host copy, queued on the device), ``submap.send``
        (the hand-off to the wire pool), ``submap.refuse`` (the global
        map's fuse, beside which the pool reads, encodes and publishes) and
        a second ``submap.send`` (the wait for that publish)."""
        col = self.submap_collection
        finished_sid = col.get_active_submap_id()
        if self.async_finalize and not self._fusion_dirty and \
                not self._active_in_global:
            self._finalize_active_submap_async(finished_sid)
            return
        if self.submap_type == Octomap:
            finish = col.export_submap     # {}: nothing on the device
        else:
            with profiling.span("submap.export"):
                finish = col.start_export_submap()
        frame_id = self.active_submap_frame_id
        with profiling.span("submap.send"):
            # the FIFO sender keeps boundary order behind queued async sends
            self._ensure_wire_workers()
            self._wire_q.put(self._wire_pool.submit(
                self._wire_submap, finish, frame_id,
                self.pgo_poses[frame_id]))
        profiling.count("submap/wire_overlapped")
        col.switch_to_next_submap()
        col.clear_last_TSDF_exporting = True
        if self.incremental_fuse and not self._fusion_dirty and \
                not self._active_in_global:
            self.global_map.fuse_submaps_incremental(col, finished_sid)
            if self.post_local_to_global_callback is not None:
                self.post_local_to_global_callback(self.global_map)
        else:
            # the active slot is fresh now, so the refuse holds exactly
            # the finished submaps
            self.local_to_global()
            self._fusion_dirty = False
            self._active_in_global = False
        with profiling.span("submap.send"):
            self._wire_q.join()    # a failed send raises in create_new_submap

    def _finalize_active_submap_async(self, finished_sid):
        """Keyframe boundary with the wire work on the worker pool. The
        gather's capacities come from earlier submaps' headers (the first
        boundary reads the block and voxel counts once); a truncated gather
        is re-gathered bigger on the worker."""
        col = self.submap_collection
        gm = self.global_map
        pose = self.pgo_poses[self.active_submap_frame_id]
        if self.submap_type == Octomap:
            # the octomap wire submap is the reference's empty dict plus
            # frame_id and pose; it still rides the FIFO sender
            self._enqueue_wire_payload(
                {"frame_id": self.active_submap_frame_id, "pose": pose})
            col.switch_to_next_submap()
            gm.fuse_submaps_incremental(col, finished_sid)
            if self.post_local_to_global_callback is not None:
                self.post_local_to_global_callback(gm)
            return
        if self._wire_caps is None:
            pack = host_read("submap.wire_caps", torch.stack([
                col.state.num_blocks.to(torch.int32) + 1,
                exports_ops.count_active(col.cfg, col.state,
                                         col.active_submap_id)]))
            self._wire_caps = self._predict_caps(int(pack[0]), int(pack[1]))
        lane_cap, blk_cap = self._wire_caps
        with profiling.span("submap.export"):
            buf = col.export_submap_async(lane_cap, blk_cap)
        # the worker reads the buffer after this event: its reads are
        # ordered after the gather whatever stream the worker uses
        done = None
        if buf.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        with profiling.span("submap.send"):
            self._ensure_wire_workers()
            self._wire_q.put(self._wire_pool.submit(
                self._wire_prepare, buf, done, lane_cap, blk_cap,
                finished_sid, self.active_submap_frame_id, pose))
        col.switch_to_next_submap()
        col.clear_last_TSDF_exporting = True
        gm.fuse_submaps_incremental(col, finished_sid, sub_bcap=blk_cap,
                                    defer_verdict=True)
        if self.post_local_to_global_callback is not None:
            self.post_local_to_global_callback(gm)

    def _predict_caps(self, blocks, vox):
        """Gather capacities with headroom over an observed (block, voxel)
        count, both on {1, 1.25, 1.5}·2^k buckets (the wire bytes scale
        with the voxel bucket, the incremental splat with the block
        bucket)."""
        col = self.submap_collection
        blk = min(bin_bucket_for(blocks + 1, 9, 8, lo=64), col.cfg.max_blocks)
        lane = min(max(bin_bucket_for(vox + 1, 5, 4), 8192),
                   col.cfg.max_blocks * col.cfg.grid.voxels_per_block)
        return lane, blk

    # -- wire workers --------------------------------------------------------
    # A pool prepares the payloads of consecutive boundaries (read, decode
    # on truncation, compress); one sender thread sends them in boundary
    # order, whichever path queued them.
    def _ensure_wire_workers(self):
        if self._wire_thread is None:
            self._wire_pool = ThreadPoolExecutor(
                max_workers=3, thread_name_prefix="submap-wire")
            self._wire_q = queue.Queue()
            self._wire_thread = threading.Thread(
                target=self._wire_sender, name="submap-wire-send",
                daemon=True)
            self._wire_thread.start()

    def _encode(self, obj):
        raw = _encode_pickle(obj) if self.wire_format == "pickle" else \
            _encode_submap_npz(obj)
        return raw, zlib.compress(raw, 1)

    def _enqueue_wire_payload(self, obj):
        """FIFO-enqueue an assembled submap dict (nothing to read from the
        device); encoding and compression run on the pool."""
        self._ensure_wire_workers()
        self._wire_q.put(self._wire_pool.submit(self._encode, obj))

    def _wire_submap(self, finish, frame_id, pose):
        """Pool task of a boundary that waits for its send: read the
        finished submap (``finish``, from ``start_export_submap``), stamp
        its frame and pose, and return the encoded payload."""
        obj = finish()
        obj["frame_id"] = frame_id
        obj["pose"] = pose
        return self._encode(obj)

    def _wire_prepare(self, buf, done, lane_cap, blk_cap, sid, frame_id,
                      pose):
        """Pool task: read the packed buffer (re-gathering bigger after a
        truncation), update the capacity prediction, and return the
        compressed payload. A re-gather reads the live collection state and
        is still exact: the finished submap's slots are never written
        again, later frames write only the new active submap's slots."""
        col = self.submap_collection
        while True:
            if done is not None:
                done.synchronize()
            buf_np = host_read("submap.wire_buffer", buf).numpy()
            head = buf_np[:16].view(np.int32)
            total_b, total_v = int(head[1]), int(head[3])
            if total_b <= blk_cap and total_v <= lane_cap:
                break
            lane_cap, blk_cap = self._predict_caps(total_b, total_v)
            print(f"[SubmapMapping] wire re-gather submap {sid}: "
                  f"{total_b} blocks / {total_v} voxels")
            buf = col.export_submap_async(lane_cap, blk_cap, submap_id=sid)
            done = None   # same thread: the copy follows the gather
        # grow-only prediction for the next boundary (pool threads race
        # this read-modify-write)
        cand = self._predict_caps(total_b, total_v)
        with self._wire_caps_lock:
            cur = self._wire_caps or (0, 0)
            self._wire_caps = (max(cand[0], cur[0]), max(cand[1], cur[1]))
        if self.wire_format == "pickle":
            # reference interop keeps the expanded per-voxel schema
            obj, _ = col.finish_export_submap(buf_np, lane_cap, blk_cap)
            obj["frame_id"] = frame_id
            obj["pose"] = pose
        else:
            obj = {
                "packed_bitmap": buf_np,
                "lane_cap": np.int64(lane_cap),
                "block_cap": np.int64(blk_cap),
                "map_scale": [col.map_size_xy, col.map_size_z],
                "voxel_scale": col.voxel_scale,
                "texture_enabled": col.enable_texture,
                "num_voxel_per_blk_axis": col.num_voxel_per_blk_axis,
                "frame_id": frame_id,
                "pose": pose,
            }
        return self._encode(obj)

    def _wire_sender(self):
        while True:
            fut = self._wire_q.get()
            try:
                raw, compressed = fut.result()
                self.map_send_handle(compressed)
                profiling.count("submap/wire_bytes", len(compressed))
                print(f"[SubmapMapping] Send submap with "
                      f"{len(raw)/1024:.1f} kB, compressed "
                      f"{len(compressed)/1024:.1f}kB (wire pool)")
            except Exception as e:
                # keep the sender alive; the failure is raised at
                # wire_join() / sync(): a dropped send would leave peers
                # without a submap the local global map holds
                print(f"[SubmapMapping] wire worker error: {e!r}")
                self._wire_errors.append(e)
            finally:
                self._wire_q.task_done()

    def wire_join(self):
        """Block until every enqueued submap is sent; raise if a send
        failed."""
        if self._wire_q is not None:
            self._wire_q.join()
        if self._wire_errors:
            errs, self._wire_errors = self._wire_errors, []
            raise RuntimeError(
                f"{len(errs)} async submap send(s) failed; peers are "
                f"missing those submaps: {errs[0]!r}") from errs[0]

    def sync(self):
        """Drain the wire workers (fuse verdicts are settled at each
        boundary). Call before reading the global map from outside or
        asserting on sent wire traffic."""
        self.wire_join()

    def create_new_submap(self, frame_id, R, T):
        if not self.first_init:
            with profiling.span("submap.finalize"):
                self._finalize_active_submap()
        with profiling.span("submap.create"):
            self.first_init = False
            sid = self.submap_collection.get_active_submap_id()
            for m in (self.global_map, self.submap_collection):
                m.set_base_pose_submap(sid, R, T)
            self.pgo_poses[frame_id] = (R, T)
            self.submaps[frame_id] = sid
            self.active_submap_frame_id = frame_id
            print(f"[SubmapMapping] Created new submap on frame {frame_id}, "
                  f"now have {sid+1} submaps")
            if self.autosave_path is not None and sid % 2 == 0:
                self.saveMap(self.autosave_path)
        if not self.async_finalize:
            # the finished submap's failed send raises here, once the next
            # submap stands: the boundary is whole, and later ones publish
            self.wire_join()
        return self.submap_collection

    def local_to_global(self):
        self.global_map.fuse_submaps(self.submap_collection)
        # the refuse may hold the (partial) active submap; an incremental
        # splat of it at its finalize would count it twice, so that
        # finalize takes the full refuse
        self._active_in_global = True
        if self.post_local_to_global_callback is not None:
            self.post_local_to_global_callback(self.global_map)

    # -- frame ingestion ----------------------------------------------------
    def recast_depth_to_map_by_frame(self, frame_id, is_keyframe, pose, ext,
                                     depthmap, texture):
        R, T = pose
        R_ext, T_ext = ext
        R, T = self.convert_by_pgo(frame_id, R, T)
        if self.need_create_new_submap(is_keyframe, R, T):
            self.create_new_submap(frame_id, R, T)
        self.submap_collection.recast_depth_to_map(R @ R_ext, T + R @ T_ext,
                                                   depthmap, texture)
        self.frame_count += 1

    def recast_depth_sequence(self, frames):
        """Batch ingest for bag replay: ``frames`` is an iterable of the
        per-frame call tuples ``(frame_id, is_keyframe, (R, T),
        (R_ext, T_ext), depthmap, texture)``. Frames between keyframe
        boundaries go through the collection's ``recast_depth_sequence``
        window; the submap lifecycle (create / finalize / global fusion)
        runs at the split points exactly as in the per-frame path."""
        run = {"R": [], "T": [], "depth": [], "tex": []}

        def flush():
            if not run["R"]:
                return
            tex = run["tex"] if run["tex"][0] is not None else None
            self.submap_collection.recast_depth_sequence(
                run["R"], run["T"], run["depth"], tex)
            run.update(R=[], T=[], depth=[], tex=[])

        for frame_id, is_keyframe, pose, ext, depthmap, texture in frames:
            R, T = self.convert_by_pgo(frame_id, *pose)
            if self.need_create_new_submap(is_keyframe, R, T):
                flush()
                self.create_new_submap(frame_id, R, T)
            R_ext, T_ext = ext
            run["R"].append(R @ R_ext)
            run["T"].append(T + R @ T_ext)
            run["depth"].append(depthmap)
            run["tex"].append(texture)
            self.frame_count += 1
        flush()

    def recast_pcl_to_map_by_frame(self, frame_id, is_keyframe, pose, ext,
                                   pcl, rgb_array):
        R, T = self.convert_by_pgo(frame_id, *pose)
        R_ext, T_ext = ext
        if self.need_create_new_submap(is_keyframe, R, T):
            self.create_new_submap(frame_id, R, T)
        Rcam, Tcam = R @ R_ext, T + R @ T_ext
        if self.submap_type == Octomap:
            self.submap_collection.recast_pcl_to_map(Rcam, Tcam, pcl,
                                                     rgb_array, len(pcl))
        else:
            self.submap_collection.recast_pcl_to_map(Rcam, Tcam, pcl,
                                                     rgb_array)
        self.frame_count += 1

    def recast_depth_to_map(self, R, T, depthmap, texture):
        if self.need_create_new_submap(True, R, T):
            self.create_new_submap(self.frame_count, R, T)
        self.submap_collection.recast_depth_to_map(R, T, depthmap, texture)
        self.frame_count += 1

    # -- display ------------------------------------------------------------
    def cvt_TSDF_to_voxels_slice(self, z):
        self.export_map.cvt_TSDF_to_voxels_slice(z)

    def cvt_TSDF_surface_to_voxels(self):
        if len(self.submaps) > 0:
            if self.exporting_global:
                self.global_map.cvt_TSDF_surface_to_voxels()
                n = self.submap_collection.cvt_TSDF_surface_to_voxels_to(
                    self.global_map.num_TSDF_particles,
                    self.global_map.max_disp_particles,
                    self.global_map.export_TSDF_xyz,
                    self.global_map.export_color)
                self.global_map.num_TSDF_particles = n
            else:
                self.submap_collection.cvt_TSDF_surface_to_voxels()

    def cvt_occupy_to_voxels(self, level=0):
        """Occupied voxels of the global map (plus the active submap) or of
        the collection. A DenseTSDF map's occupancy view is its surface
        export, so that type takes :meth:`cvt_TSDF_surface_to_voxels`."""
        if self.submap_type != Octomap:
            self.cvt_TSDF_surface_to_voxels()
            return
        if self.exporting_global:
            self.global_map.cvt_occupy_to_voxels(level)
            n = self.submap_collection.cvt_occupy_voxels_to(
                level, self.global_map.num_export_particles,
                self.global_map.max_disp_particles,
                self.global_map.export_x, self.global_map.export_color)
            self.global_map.num_export_particles = n
        else:
            self.submap_collection.cvt_occupy_to_voxels(level)

    # -- wire exchange ------------------------------------------------------
    def send_submap(self, submap):
        submap["frame_id"] = self.active_submap_frame_id
        submap["pose"] = self.pgo_poses[self.active_submap_frame_id]
        with profiling.span("submap.send") as sp:
            raw, compressed = self._encode(submap)
            self.map_send_handle(compressed)
        profiling.count("submap/wire_bytes", len(compressed))
        print(f"[SubmapMapping] Send submap with {len(raw)/1024.0:.1f} kB, "
              f"compressed {len(compressed)/1024:.1f}kB compress cost "
              f"{sp.ms:.1f}ms")

    def send_traj(self, traj):
        raw = _encode_pickle(traj) if self.wire_format == "pickle" else \
            _encode_traj_npz(traj)
        self.traj_send_handle(zlib.compress(raw, 1))

    # decompression bomb guard: a small hostile datagram may expand without
    # bound; cap the plaintext at a generous multiple of any real submap
    MAX_WIRE_PLAINTEXT = 256 * 1024 * 1024

    def _decode_wire(self, buf, npz_decoder, what):
        """Detect the inbound format; a pickle payload is decoded only with
        ``wire_format="pickle"``."""
        d = zlib.decompressobj()
        raw = d.decompress(buf, self.MAX_WIRE_PLAINTEXT)
        if d.unconsumed_tail:
            raise ValueError(
                f"{what} payload exceeds {self.MAX_WIRE_PLAINTEXT} B "
                "decompressed (bomb guard)")
        if raw[:2] == b"PK":                      # npz (zip) magic
            return npz_decoder(raw)
        if raw[:6] == b"\x93NUMPY":
            if self.wire_format != "pickle":
                print(f"[SubmapMapping] DROPPED pickle-npy {what} from the "
                      "wire: wire_format='npz' refuses pickled payloads "
                      "(set wire_format='pickle' for reference-peer interop "
                      "on a trusted network)")
                return None
            return np.load(io.BytesIO(raw), allow_pickle=True).item()
        print(f"[SubmapMapping] DROPPED unrecognized {what} payload")
        return None

    def input_remote_submap(self, buf):
        print(f"[SubmapMapping] Recv submap with {len(buf)/1024:.1f} kB")
        submap = self._decode_wire(buf, _decode_submap_npz, "submap")
        if submap is None:
            return
        idx = self.submap_collection.input_remote_submap(submap)
        self.global_map.set_base_pose_submap(idx, submap["pose"][0],
                                             submap["pose"][1])
        if self.incremental_fuse and not self._fusion_dirty:
            self.global_map.fuse_submaps_incremental(self.submap_collection,
                                                     idx)
            if self.post_local_to_global_callback is not None:
                self.post_local_to_global_callback(self.global_map)
        else:
            self.local_to_global()
            self._fusion_dirty = False
        self.submaps[submap["frame_id"]] = idx

    def input_remote_traj(self, buf):
        traj = self._decode_wire(buf, _decode_traj_npz, "traj")
        if traj is None:
            return
        self.set_frame_poses(traj, True)
        print(f"[SubmapMapping] Recv traj with {len(traj)} poses "
              f"{len(buf)/1024.0:.1f} kB")

    def flush(self):
        """Send the still-active submap (shutdown): a submap is otherwise
        sent only when the next one is created, so the work since the last
        keyframe would never reach peers."""
        if self.frame_count == 0 or self.first_init:
            return
        self.sync()   # earlier async sends go first
        self.send_submap(self.submap_collection.export_submap())

    def saveMap(self, filename):
        self.global_map.saveMap(filename)

    def export_submap(self):
        return self.submap_collection.export_submap()
