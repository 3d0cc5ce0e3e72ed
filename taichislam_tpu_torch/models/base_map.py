"""BaseMap: shared pose state, camera intrinsics and submap registry.

Host-side numpy, as in the JAX package's ``models/base_map.py``: per-submap
base rotations start at identity (the reference starts them at zeros), and
poses are stored in the active submap's frame.
"""

from __future__ import annotations

import numpy as np
import torch

from taichislam_tpu_torch.core import geometry
from taichislam_tpu_torch.core.colormap import jet_lut_np, jet_rgba_np
from taichislam_tpu_torch.core.device import resolve_device  # noqa: F401


class BaseMap:
    def __init__(self, voxel_scale: float):
        self.voxel_scale = voxel_scale
        self.input_R = np.eye(3, dtype=np.float32)
        self.input_T = np.zeros(3, dtype=np.float32)
        self.base_R_np = np.eye(3)
        self.base_T_np = np.zeros(3)
        self.frame_id = 0
        self.submap_enabled = False
        self.K_cam_dep = None
        self.K_cam_color = None
        self.colormap = jet_lut_np()

    def _tensor(self, a, dtype=None):
        """``a`` as a tensor on the map's ``device``: host arrays are
        copied there; a torch tensor (on any device) moves there and takes
        ``dtype`` with ``Tensor.to``, which copies nothing when it is
        already there, so frames staged on the card stay on the card."""
        if isinstance(a, torch.Tensor):
            tdt = None if dtype is None else \
                torch.from_numpy(np.empty(0, dtype)).dtype
            return a.to(device=self.device, dtype=tdt)
        return torch.as_tensor(np.asarray(a, dtype=dtype), device=self.device)

    def _input(self, a, dtype=None):
        """``a`` as an op's per-call input: on the card host data stays on
        the host, as numpy (the op's CUDA graph stages it into its slot
        through pinned memory) and a tensor moves as :meth:`_tensor` moves
        it; on the CPU :meth:`_tensor`."""
        if self.device.type != "cuda" or isinstance(a, torch.Tensor):
            return self._tensor(a, dtype)
        return np.asarray(a, dtype=dtype)

    # -- camera ------------------------------------------------------------
    def set_dep_camera_intrinsic(self, K):
        """K is a flattened row-major 3x3."""
        self.K_cam_dep = np.asarray(K, np.float32).reshape(-1)

    def set_color_camera_intrinsic(self, K):
        self.K_cam_color = np.asarray(K, np.float32).reshape(-1)

    # -- pose --------------------------------------------------------------
    def convert_by_base(self, R, T):
        if self.submap_enabled:
            base_R = self.submaps_base_R_np[self.active_submap_id]
            base_T = self.submaps_base_T_np[self.active_submap_id]
        else:
            base_R, base_T = self.base_R_np, self.base_T_np
        return geometry.convert_by_base(base_R, base_T, R, T)

    def set_pose(self, _R, _T):
        """Store the sensor pose expressed in the active submap's frame."""
        R_, T_ = self.convert_by_base(np.asarray(_R), np.asarray(_T))
        self.input_R = R_.astype(np.float32)
        self.input_T = T_.astype(np.float32)

    def set_base_pose(self, _R, _T):
        self.base_R_np = np.asarray(_R, np.float64)
        self.base_T_np = np.asarray(_T, np.float64)

    def recast_depth_to_map_by_frame(self, frame_id, is_keyframe, pose, ext,
                                     depthmap, texture):
        """Apply the camera extrinsic and forward to recast_depth_to_map."""
        R, T = pose
        R_ext, T_ext = ext
        self.recast_depth_to_map(R @ R_ext, T + R @ T_ext, depthmap, texture)

    def recast_pcl_to_map_by_frame(self, frame_id, is_keyframe, pose, ext,
                                   pcl, rgb_array):
        """Apply the sensor extrinsic and forward to recast_pcl_to_map."""
        R, T = pose
        R_ext, T_ext = ext
        self.recast_pcl_to_map(R @ R_ext, T + R @ T_ext, pcl, rgb_array)

    # -- submap registry -----------------------------------------------------
    def _trace_scalars(self):
        """0-d device tensors a traced frame's record keeps
        (``utils/profiling.frame_end``); none here."""
        return {}

    def initialize_submap_fields(self, max_submap_num: int):
        self.submap_enabled = True
        self.max_submap_num = max_submap_num
        self.submaps_base_R_np = np.tile(np.eye(3, dtype=np.float32),
                                         (max_submap_num, 1, 1))
        self.submaps_base_T_np = np.zeros((max_submap_num, 3), np.float32)
        self.active_submap_id = 0
        self.remote_submap_num = 0

    def get_active_submap_id(self):
        return self.active_submap_id

    def switch_to_next_submap(self):
        self.finalization_current_submap()
        self.active_submap_id += 1
        return self.active_submap_id

    def set_base_pose_submap(self, submap_id, _R, _T):
        self.submaps_base_R_np[submap_id] = np.asarray(_R, np.float32)
        self.submaps_base_T_np[submap_id] = np.asarray(_T, np.float32)

    def finalization_current_submap(self):
        pass

    # -- display helper --------------------------------------------------
    def render_occupy_map_to_particles(self, pars, pos_, colors,
                                       num_particles_, voxel_scale):
        """Hand the first ``num_particles_`` exported positions to a particle
        renderer ``pars`` (set_particles, set_particle_radii,
        set_particle_colors); untextured maps color them by height with
        jet."""
        if num_particles_ == 0:
            return
        pos = pos_[0:num_particles_, :]
        if not self.enable_texture:
            max_z = np.max(pos[:, 2])
            min_z = np.min(pos[:, 2])
            rng = max(max_z - min_z, 1e-9)
            colors = jet_rgba_np((pos[:, 2] - min_z) / rng)
        pars.set_particles(pos)
        pars.set_particle_radii(np.ones(num_particles_) * voxel_scale / 2)
        pars.set_particle_colors(colors)
