"""The node's map, worked out again from the frames it took.

``NodeReference`` reads the node's parameters with the node's documented
defaults and replays, in order, the frames the node processed: each frame's
messages decoded as the node decodes them, its depth fused into the map
(``tsdf.integrate``), and

- with submaps: a new submap at the first frame and at every
  ``keyframe_step``-th frame, each submap's frame its first pose (held in
  f32), and at each boundary the global map rebuilt from every finished
  submap by a trilinear splat of their observed voxels through their base
  poses (seven corners, the lower corner left out), merged by the weighted
  average with no weight cap;
- with the esdf mapping type: the ESDF's snapshot refreshed after every
  frame (``esdf.refresh_snapshot``), and, at the frames asked for, the
  surface cloud and ESDF slice the node publishes.

The grids are dense boxes around the scene's bounds; a sample that lands in
the map but outside its box is counted in ``outside`` (it would make the
reference wrong, so a non-zero count fails the check).
"""

from __future__ import annotations

import numpy as np
import torch

from . import esdf as esdf_ref
from . import exports
from .geometry import pose_from_msg
from .tsdf import MAX_BINS, Grid, Sensor, Spec, bucket_for, integrate

# the node's defaults (its code defaults, upstream taichislam_node.py's)
DEFAULTS = {
    "~voxel_scale": 0.05, "~map_size_xy": 100, "~map_size_z": 10,
    "~max_ray_length": 5.1, "~min_ray_length": 0.3,
    "~texture_enabled": True, "~color_same_proj": False,
    "~num_voxel_per_blk_axis": 16, "~keyframe_step": 10,
    "~enable_submap": False, "~mapping_type": "tsdf", "~output_map": False,
    "~esdf/publish_slice_z": None, "~disp_ceiling": 1.8,
    "~disp_floor": -0.3,
    "Kdepth/fx": 384.2377014160156, "Kdepth/cx": 323.4873046875,
    "Kdepth/fy": 384.2377014160156, "Kdepth/cy": 235.0628204345703,
    "Kcolor/fx": 384.2377014160156, "Kcolor/cx": 323.4873046875,
    "Kcolor/fy": 384.2377014160156, "Kcolor/cy": 235.0628204345703,
}


def intrinsics(p, name):
    """The flattened 3x3 intrinsics ``name`` (Kdepth, Kcolor) of the
    node's parameters ``p``, f32."""
    return np.array([p[f"{name}/fx"], 0.0, p[f"{name}/cx"], 0.0,
                     p[f"{name}/fy"], p[f"{name}/cy"], 0.0, 0.0, 1.0],
                    np.float32)


def _box_in(base_R, base_T, lo, hi):
    """The bounds of the world box [lo, hi] in a base pose's frame."""
    R = np.asarray(base_R, np.float64)
    T = np.asarray(base_T, np.float64)
    c = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                  for z in (lo[2], hi[2])])
    loc = (c - T) @ R
    return loc.min(0), loc.max(0)


class NodeReference:
    def __init__(self, params: dict, bounds, device, dtype=torch.float32):
        p = dict(DEFAULTS, **params)
        self.p = p
        self.device, self.dtype = device, dtype
        self.voxel = float(p["~voxel_scale"])
        self.spec = Spec(self.voxel, int(p["~num_voxel_per_blk_axis"]),
                         float(p["~map_size_xy"]), float(p["~map_size_z"]))
        self.submap = bool(p["~enable_submap"])
        self.esdf = (not self.submap) and p["~mapping_type"] == "esdf"
        self.texture = bool(p["~texture_enabled"])
        self.sensor = Sensor(self.voxel, float(p["~max_ray_length"]),
                             float(p["~min_ray_length"]), self.texture,
                             bool(p["~color_same_proj"]))
        self.K = torch.from_numpy(intrinsics(p, "Kdepth")).to(device)
        self.Kc = torch.from_numpy(intrinsics(p, "Kcolor")).to(device)
        self.step = int(p["~keyframe_step"])
        pad = (10 + 3) * self.voxel
        self.lo = [b - pad for b in bounds[0]]
        self.hi = [b + pad for b in bounds[1]]
        self.bucket = min(4096, MAX_BINS)
        self.frame_count = 0
        self.outside = 0
        self.submaps = []       # finished: (R32, T32, ijk, tsdf, w)
        self.active = None      # (R32, T32, grid)
        self.global_from = 0    # submaps in the last global rebuild
        self.exports = {}       # frame number -> published clouds
        if not self.submap:
            self.grid = Grid(self.spec, self.lo, self.hi, self.texture, dtype,
                             device)
            if self.esdf:
                n = self.grid.tsdf.numel()
                self.seen_tsdf = torch.zeros(n, device=device)
                self.seen_obs = torch.zeros(n, dtype=torch.bool,
                                            device=device)

    # -- frames ---------------------------------------------------------
    def frame(self, frame_msg, depth, tex, export=False):
        """Replay one processed frame: ``depth`` (h, w) int32 and ``tex``
        (h, w, 3) uint8 tensors on the device (``tex`` None untextured)."""
        R, T = pose_from_msg(frame_msg.odom.pose.pose)
        Re, Te = pose_from_msg(frame_msg.extrinsics[0])
        Rc, Tc = R @ Re, T + R @ Te
        if self.submap:
            if self.frame_count == 0 or (
                    frame_msg.is_keyframe and
                    self.frame_count % self.step == 0):
                self._new_submap(R, T)
            bR, bT, grid = self.active
        else:
            bR, bT, grid = (np.eye(3, dtype=np.float32),
                            np.zeros(3, np.float32), self.grid)
        Rb = np.asarray(bR, np.float32)
        R_ = (Rb.T @ Rc).astype(np.float32)
        T_ = (Rb.T @ (Tc - np.asarray(bT, np.float32))).astype(np.float32)
        dev = self.device
        total, touched = integrate(
            self.spec, grid, self.sensor, depth, tex,
            torch.from_numpy(R_).to(dev), torch.from_numpy(T_).to(dev),
            self.K, self.Kc, self.bucket)
        self.bucket = min(bucket_for(total), MAX_BINS)
        self.frame_count += 1
        if self.esdf:
            esdf_ref.refresh_snapshot(grid, self.seen_tsdf, self.seen_obs,
                                      touched)
        if export:
            self.exports[self.frame_count] = self.published()

    def outside_total(self) -> int:
        """Samples in the map that fell outside the reference's boxes."""
        grid = self.active[2] if self.submap else self.grid
        return self.outside + (grid.outside if grid is not None else 0)

    @staticmethod
    def _observed(grid):
        """(ijk, tsdf, w) of a grid's observed voxels."""
        i, j, k = grid.ijk()
        m = grid.obs
        return (torch.stack([i[m], j[m], k[m]], 1), grid.tsdf[m].float(),
                grid.w[m].float())

    def _new_submap(self, R, T):
        if self.active is not None:
            bR, bT, grid = self.active
            self.outside += grid.outside
            self.submaps.append((bR, bT) + self._observed(grid))
            self.global_from = len(self.submaps)
        bR = np.asarray(R, np.float32)
        bT = np.asarray(T, np.float32)
        lo, hi = _box_in(bR, bT, self.lo, self.hi)
        self.active = (bR, bT, Grid(self.spec, lo, hi, self.texture,
                                    self.dtype, self.device))

    # -- results --------------------------------------------------------
    def submap_voxels(self):
        """(ijk, submap id, tsdf, w) of the observed voxels of every
        submap, the active one included."""
        parts = [sm[2:] for sm in self.submaps] + [
            self._observed(self.active[2])]
        sub = torch.cat([torch.full((p[0].shape[0],), s, device=self.device)
                         for s, p in enumerate(parts)])
        return (torch.cat([p[0] for p in parts]), sub,
                torch.cat([p[1] for p in parts]),
                torch.cat([p[2] for p in parts]))

    def esdf_field(self):
        """(esdf, participate) of the map's snapshot, flat over the box."""
        e = esdf_ref.fixed_point(self.grid, self.seen_tsdf, self.seen_obs,
                                 self.voxel, self.sensor.max_ray)
        return e, self.seen_obs

    def published(self):
        """The clouds the node publishes after a frame, in order."""
        p = self.p
        out = []
        if not self.p["~output_map"] or self.submap:
            return out
        out.append(exports.surface(self.grid, self.voxel,
                                   float(p["~disp_floor"]),
                                   float(p["~disp_ceiling"])))
        if self.esdf and p["~esdf/publish_slice_z"] is not None:
            e, part = self.esdf_field()
            out.append(exports.esdf_slice(
                self.grid, e, part, self.voxel,
                float(p["~esdf/publish_slice_z"])))
        return out

    def global_map(self, gspec: Spec):
        """The global map after the last boundary: a grid over the world
        box holding the splat of the submaps finished by then."""
        g = Grid(gspec, self.lo, self.hi, False, self.dtype, self.device)
        n = g.tsdf.numel()
        w_sum = torch.zeros(n, device=self.device)
        wd_sum = torch.zeros(n, device=self.device)
        vs = float(np.float32(self.voxel))
        inv_gv = float(np.float32(1.0 / gspec.voxel))
        from .geometry import dot3
        for bR, bT, ijk, tsdf, w in self.submaps[:self.global_from]:
            R = torch.from_numpy(np.asarray(bR, np.float32)).to(self.device)
            T = torch.from_numpy(np.asarray(bT, np.float32)).to(self.device)
            loc = [ijk[:, a].float() * vs for a in range(3)]
            gf = [(dot3(R[a, 0], loc[0], R[a, 1], loc[1], R[a, 2], loc[2])
                   + T[a]) * inv_gv for a in range(3)]
            low = [torch.floor(x).to(torch.int32) for x in gf]
            fr = [x - lo.float() for x, lo in zip(gf, low)]
            for di in (0, 1):
                for dj in (0, 1):
                    for dk in (0, 1):
                        if di + dj + dk == 0:
                            continue
                        wgt = ((fr[0] if di else 1.0 - fr[0]) *
                               (fr[1] if dj else 1.0 - fr[1]) *
                               (fr[2] if dk else 1.0 - fr[2]))
                        gi, gj, gk = low[0] + di, low[1] + dj, low[2] + dk
                        ok = gspec.in_map(gi, gj, gk) & (wgt > 0)
                        flat, inbox = g.flat(gi, gj, gk)
                        g.outside += int((ok & ~inbox).sum())
                        ok &= inbox
                        lw = wgt * w
                        w_sum.index_add_(0, flat[ok], lw[ok])
                        wd_sum.index_add_(0, flat[ok], (lw * tsdf)[ok])
        touched = w_sum > 0
        g.tsdf.copy_(torch.where(touched, wd_sum / w_sum, 0.0).to(self.dtype))
        g.w.copy_(w_sum.to(self.dtype))
        g.obs |= touched
        return g
