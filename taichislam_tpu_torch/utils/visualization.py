"""Headless-friendly 3D renderer with TaichiSLAM's GGUI API surface.

Counterpart of the JAX package's ``utils/visualization.py``; it takes numpy
arrays. TaichiSLAM's TaichiSLAMRender (``taichi_slam/utils/visualization.py``)
is an interactive Taichi-GGUI viewer: particle clouds, meshes,
skeleton-graph lines, per-drone pose triads/trajectories, orbit camera.
Compute hosts often have no display stack, so this rebuild renders the same
scene content with matplotlib 3D, either interactively (``show=True`` when
a display exists) or headless to PNG frames (``save_path``) — which is also
what CI can assert on. The staging API (``set_particles``, ``set_lines``,
``set_mesh``, ``set_skeleton_graph_edges``, ``set_drone_pose``,
``set_drone_trajectory``, ``rendering``, camera fields) matches TaichiSLAM's
names so node code is drop-in. Only ``rendering()`` needs matplotlib; a host
without it serves the scene with ``viewer_server.InteractiveRender``.
"""

from __future__ import annotations

import numpy as np


class TaichiSLAMRender:
    def __init__(self, RES_X=1920, RES_Y=1080, show=False, save_path=None,
                 max_particles_draw=200000):
        self.RES_X, self.RES_Y = RES_X, RES_Y
        self.show = show
        self.save_path = save_path
        self.max_particles_draw = max_particles_draw
        self._subsample_warned = False

        self.camera_yaw = 0.0
        self.camera_pitch = -0.5
        self.camera_distance = 3.0
        self.camera_min_distance = 0.3
        self.camera_lookat = np.array([0.0, 0.0, 0.0])
        self.lock_pos_drone = False
        self.enable_mesher = True
        self.disp_particles = True
        self.disp_mesh = True
        self.particle_radius = 0.025
        self.enable_slice_z = False
        self.slice_z = 0.0

        self.par = None
        self.par_color = None
        self.lines = None
        self.lines_color = None
        self.mesh_vertices = None
        self.mesh_colors = None
        self.skeleton_edges = {}
        self.drone_poses = {}
        self.drone_trajs = {}
        self.frame_count = 0
        self._fig = None

    # -- staging API (reference names) ---------------------------------------
    def set_particles(self, par, color, num=None):
        n = len(par) if num is None else num
        self.par = np.asarray(par)[:n]
        self.par_color = np.asarray(color)[:n] if color is not None else None

    def set_lines(self, lines, color=None, num=None):
        n = len(lines) if num is None else num
        self.lines = np.asarray(lines)[:n]
        self.lines_color = np.asarray(color)[:n] if color is not None else None

    def set_mesh(self, mesh, color, normals=None, indices=None,
                 mesh_num=None):
        n = len(mesh) if mesh_num is None else mesh_num * 3
        self.mesh_vertices = np.asarray(mesh)[:n]
        self.mesh_colors = np.asarray(color)[:n] if color is not None else None

    def set_skeleton_graph_edges(self, edges, drone_id=0):
        self.skeleton_edges[drone_id] = np.asarray(edges)

    def set_drone_pose(self, drone_id, R, T):
        self.drone_poses[drone_id] = (np.asarray(R), np.asarray(T))
        if self.lock_pos_drone:
            self.camera_lookat = np.asarray(T, np.float64)

    def set_drone_trajectory(self, drone_id, trajectory):
        self.drone_trajs[drone_id] = np.asarray(trajectory)

    @property
    def drone_num(self):
        return max(len(self.drone_poses), 1)

    # -- rendering -----------------------------------------------------------
    def _axes(self):
        import matplotlib
        if not self.show:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        if self._fig is None:
            self._fig = plt.figure(
                figsize=(self.RES_X / 100.0, self.RES_Y / 100.0))
        self._fig.clf()
        ax = self._fig.add_subplot(projection="3d")
        ax.set_box_aspect((1, 1, 1))
        return plt, ax

    def rendering(self):
        """Draw the staged scene; save/show a frame
        (visualization.py:217-242 analog)."""
        plt, ax = self._axes()
        if self.disp_particles and self.par is not None and len(self.par):
            p = self.par
            if len(p) > self.max_particles_draw:
                if not self._subsample_warned:
                    self._subsample_warned = True
                    print(f"[Render] drawing {self.max_particles_draw} of "
                          f"{len(p)} particles (matplotlib cap); use the "
                          "WebGL viewer (InteractiveRender) for full "
                          "fidelity")
                sel = np.random.default_rng(0).choice(
                    len(p), self.max_particles_draw, replace=False)
                p = p[sel]
                c = self.par_color[sel] if self.par_color is not None else None
            else:
                c = self.par_color
            ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=1,
                       c=np.clip(c[:, :3], 0, 1) if c is not None else "b")
        if self.disp_mesh and self.mesh_vertices is not None and \
                len(self.mesh_vertices):
            from mpl_toolkits.mplot3d import art3d
            tris = self.mesh_vertices.reshape(-1, 3, 3)
            pc = art3d.Poly3DCollection(tris, alpha=0.6)
            if self.mesh_colors is not None and len(self.mesh_colors):
                pc.set_facecolor(np.clip(
                    self.mesh_colors.reshape(-1, 3, 3).mean(axis=1), 0, 1))
            ax.add_collection(pc)
        if self.lines is not None and len(self.lines):
            seg = self.lines.reshape(-1, 2, 3)
            for a, b in seg:
                ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], "k-",
                        linewidth=0.5)
        for _, edges in self.skeleton_edges.items():
            for a, b in np.asarray(edges).reshape(-1, 2, 3):
                ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], "g-")
        for drone_id, (R, T) in self.drone_poses.items():
            for axis, col in zip(range(3), "rgb"):
                tip = T + R[:, axis] * 0.3
                ax.plot([T[0], tip[0]], [T[1], tip[1]], [T[2], tip[2]], col)
        for drone_id, traj in self.drone_trajs.items():
            if len(traj):
                ax.plot(traj[:, 0], traj[:, 1], traj[:, 2], "b--",
                        linewidth=0.8)

        d = self.camera_distance
        ax.set_xlim(self.camera_lookat[0] - d, self.camera_lookat[0] + d)
        ax.set_ylim(self.camera_lookat[1] - d, self.camera_lookat[1] + d)
        ax.set_zlim(self.camera_lookat[2] - d, self.camera_lookat[2] + d)
        ax.view_init(elev=-np.rad2deg(self.camera_pitch),
                     azim=np.rad2deg(self.camera_yaw))

        if self.save_path is not None:
            self._fig.savefig(f"{self.save_path}/frame_{self.frame_count:05d}.png",
                              dpi=100)
        if self.show:
            plt.pause(0.001)
        self.frame_count += 1

    def options(self):
        pass

    def handle_events(self):
        pass

    def close(self):
        if self._fig is not None:
            import matplotlib.pyplot as plt
            plt.close(self._fig)
            self._fig = None
