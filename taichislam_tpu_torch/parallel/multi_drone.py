"""SPMD multi-drone mapping over a process-group mesh.

Counterpart of the JAX package's ``parallel/multi_drone.py``. The reference
exchanges submaps between drones over UDP multicast and fuses them on every
peer; when a fleet is simulated (or co-located) on one host, this module
replaces that with collectives:

- each rank owns one drone: its depth stream, pose, submap collection and
  base-pose registry (the JAX arrays' leading ``drone`` axis is the rank);
- per step, every rank integrates its own frame with the single-device ops
  (K1 at bins and march; K3 for the per-drone ESDF; marching cubes for the
  per-drone mesh patch) — purely local work;
- global fusion: every rank splats its collection into the replicated
  global grid's geometry, the touched-block bitmaps are OR'd over ranks,
  allocation runs on the union (a deterministic prefix sum, so every rank
  derives the same slots), and the dense per-voxel accumulators, reduced
  per block by K1, are summed over ranks before the closed-form merge.

The per-drone lifecycle registry (active submap, frame count, base poses)
is host state, as ``SubmapMapping`` keeps it; the grids are tensors on the
mesh's device, updated in place.
"""

from __future__ import annotations

import numpy as np
import torch

from taichislam_tpu_torch.core.config import TSDFConfig
from taichislam_tpu_torch.core.grid import GridState, allocate_from_touched
from taichislam_tpu_torch.ops import fusion as fusion_ops
from taichislam_tpu_torch.ops import tsdf as tsdf_ops
from taichislam_tpu_torch.parallel.mesh import Mesh


def make_drone_states(cfg: TSDFConfig, *, device=None) -> GridState:
    """This rank's drone's submap-collection state (the JAX function
    stacks ``n_drones`` on a leading axis; rank ``r`` holds drone
    ``r``), on ``device`` (the CUDA card unless given). ``device`` is
    keyword-only, so that a call in JAX's form raises."""
    return tsdf_ops.make_tsdf_state(cfg, device=device)


def fuse_contributions(glob_cfg: TSDFConfig, mesh: Mesh, gstate: GridState,
                       c: fusion_ops.SplatContribs) -> GridState:
    """Fuse every rank's splat ``c`` into the replicated global map: OR the
    touched bitmaps, allocate, sum the dense accumulators over ranks, merge.
    In place; returns the state."""
    touched = mesh.any(fusion_ops.accumulate_dense(glob_cfg, gstate, c))
    gstate = allocate_from_touched(glob_cfg.grid, gstate, touched, 0)
    w, wd, occ, wc = fusion_ops.scatter_accumulators(glob_cfg, gstate, c)
    # untextured splats carry no color sums: zeros need no reduction
    wc = mesh.psum(wc) if glob_cfg.texture_enabled else wc
    return fusion_ops.combine_accumulators(
        glob_cfg, gstate, mesh.psum(w), mesh.psum(wd), mesh.psum(occ), wc)


def multi_drone_step(sub_cfg: TSDFConfig, glob_cfg: TSDFConfig,
                     max_fuse_blocks: int, mesh: Mesh, axis: str = "drone"):
    """The SPMD step ``fn(dstate, gstate, depth, R, T, K, base_R, base_T)
    -> (dstate, gstate)``: this rank's drone integrates its frame (depth,
    R, T are this rank's) into submap 0 of its collection, then every
    drone's collection fuses into the replicated global map through the
    shared base poses ``base_R`` (S, 3, 3) / ``base_T`` (S, 3)."""

    def step(dstate, gstate, depth, R, T, K, base_R, base_T):
        tex = torch.zeros((1, 1, 3), dtype=torch.uint8, device=depth.device)
        dstate, _ = tsdf_ops.integrate_depth(sub_cfg, dstate, depth, tex, R,
                                             T, K, K, 0)
        c = fusion_ops.splat_contributions(sub_cfg, glob_cfg,
                                           max_fuse_blocks, dstate, base_R,
                                           base_T)
        return dstate, fuse_contributions(glob_cfg, mesh, gstate, c)

    return step


# ---------------------------------------------------------------------------
# lifecycle-composed SPMD step (the in-graph SubmapMapping)
# ---------------------------------------------------------------------------

def make_lifecycle_states(sub_cfg: TSDFConfig, *, with_esdf: bool = False,
                          device=None) -> dict:
    """This rank's drone's lifecycle state: its submap-collection grid
    ``state``, the ``active`` submap id and ``fcount`` frame count (ints),
    and its base-pose registry ``base_R`` (S, 3, 3) / ``base_T`` (S, 3)
    f32 numpy arrays, kept on the host as ``SubmapMapping`` keeps them.
    With ``with_esdf`` also the drone's distance field: ``esdf`` /
    ``fixed`` full-map tensors, the ``pending`` re-queue bitmap chaining
    wavefronts across frames, and ``esdf_stats`` (sweeps run, overflow).
    The options are keyword-only, so that a call in JAX's form, which
    passes ``n_drones`` second, raises."""
    S = sub_cfg.max_submap_num
    state = make_drone_states(sub_cfg, device=device)
    dev = state.table.device
    life = dict(state=state, active=0, fcount=0,
                base_R=np.tile(np.eye(3, dtype=np.float32), (S, 1, 1)),
                base_T=np.zeros((S, 3), np.float32))
    if with_esdf:
        nb = sub_cfg.grid.max_blocks + 1
        V3 = sub_cfg.grid.voxels_per_block
        life["esdf"] = torch.zeros((nb, V3), dtype=torch.float32, device=dev)
        life["fixed"] = torch.zeros((nb, V3), dtype=torch.int8, device=dev)
        life["pending"] = torch.zeros((nb,), dtype=torch.bool, device=dev)
        life["esdf_stats"] = torch.zeros((2,), dtype=torch.int32, device=dev)
    return life


def lifecycle_pose(life: dict, keyframe_step: int, S: int, R, T, kf: bool):
    """The keyframe policy and pose conversion of one frame, on the host:
    a new submap on frame 0 and on every ``keyframe_step``-th keyframe,
    registered at the current world pose; returns (active submap, R_in,
    T_in), the pose in that submap's frame (f32), and updates ``life``'s
    registry. ``R`` / ``T`` may be numpy arrays or tensors on any
    device."""
    R0, T0 = (np.asarray(x.cpu() if torch.is_tensor(x) else x, np.float32)
              for x in (R, T))
    fcnt, act = life["fcount"], life["active"]
    new = fcnt == 0 or (bool(kf) and fcnt % keyframe_step == 0)
    act1 = min(act + 1 if (new and fcnt > 0) else act, S - 1)
    if new:
        life["base_R"][act1] = R0
        life["base_T"][act1] = T0
    baR, baT = life["base_R"][act1], life["base_T"][act1]
    life["active"], life["fcount"] = act1, fcnt + 1
    return act1, baR.T @ R0, baR.T @ (T0 - baT)


def multi_drone_lifecycle_step(sub_cfg: TSDFConfig, keyframe_step: int,
                               mesh: Mesh, axis: str = "drone",
                               esdf_sweeps: int | None = None,
                               esdf_block_cap: int = 64,
                               mesh_triangles: int | None = None,
                               mesh_block_cap: int = 32):
    """The SPMD frame step with the submap lifecycle — the per-rank form
    of ``SubmapMapping.recast_depth_to_map_by_frame``: keyframe policy,
    base-pose registration, world -> submap pose conversion and
    integration into the active submap.

    ``fn(life, depth, R, T, is_keyframe, K) -> life``, where ``life`` is
    this rank's dict from :func:`make_lifecycle_states` and depth / R / T /
    is_keyframe are this rank's frame. Global fusion is separate
    (:func:`multi_drone_fuse`).

    With ``esdf_sweeps`` each drone also runs its budget-bounded
    incremental ESDF (``ops.esdf.esdf_update``: K3 at a budget of 2 or
    more) on this frame's touched blocks OR the pending re-queue bitmap; on
    a working-set overflow the frame's whole dirty set re-queues.

    With ``mesh_triangles`` each drone also extracts its incremental mesh
    patch (marching cubes on the 26-dilation of this frame's touched
    blocks) and the step returns ``(life, mesh_out)``: ``vertices``
    (mesh_triangles*3, 3) and ``counts`` (num_triangles,
    surface_blocks_dropped, triangles_dropped)."""
    S = sub_cfg.max_submap_num

    def step(life, depth, R, T, kf, K):
        st = life["state"]
        dev = st.table.device
        act1, R_in, T_in = lifecycle_pose(life, keyframe_step, S, R, T, kf)
        tex = torch.zeros((1, 1, 3), dtype=torch.uint8, device=dev)
        st, stats = tsdf_ops.integrate_depth(
            sub_cfg, st, depth, tex, torch.as_tensor(R_in, device=dev),
            torch.as_tensor(T_in, device=dev), K, K, act1)
        life["state"] = st
        if esdf_sweeps is not None:
            from taichislam_tpu_torch.ops import esdf as esdf_ops
            dirty = stats["touched_blocks"] | life["pending"]
            e, f, _, sweeps, changed, ovf = esdf_ops.esdf_update(
                sub_cfg, esdf_sweeps, esdf_block_cap, st, life["esdf"],
                life["fixed"], act1, dirty)
            life["esdf"], life["fixed"] = e, f
            life["pending"] = torch.where(ovf > 0, changed | dirty, changed)
            life["esdf_stats"] = torch.stack([sweeps.to(torch.int32),
                                              ovf.to(torch.int32)])
        if mesh_triangles is None:
            return life
        from taichislam_tpu_torch.ops import marching_cubes as mc_ops
        dil = mc_ops.dilate_blocks(sub_cfg, st, act1,
                                   stats["touched_blocks"])
        m = mc_ops.extract_mesh(sub_cfg, mesh_triangles, 1, mesh_block_cap,
                                st, act1, sub_cfg.tsdf_surface_thres,
                                block_mask=dil)
        tris_dropped = torch.clamp(m["total_triangles"] -
                                   m["num_triangles"], min=0)
        return life, dict(vertices=m["vertices"], counts=torch.stack([
            m["num_triangles"].to(torch.int32),
            m["surface_blocks_dropped"].to(torch.int32),
            tris_dropped.to(torch.int32)]))

    return step


def multi_drone_fuse(sub_cfg: TSDFConfig, glob_cfg: TSDFConfig,
                     max_fuse_blocks: int, mesh: Mesh, axis: str = "drone",
                     with_esdf: bool = False):
    """The all-drone global fusion ``fn(life, gstate) -> gstate``: every
    rank splats its own collection through its own base-pose registry, and
    every rank derives the same replicated global map — the collective
    form of one ``fuse_submaps`` per drone (an associative weighted merge).
    ``with_esdf`` is accepted for the JAX signature; the ESDF entries of
    ``life`` are not read."""

    def fuse(life, gstate):
        st = life["state"]
        dev = st.table.device
        c = fusion_ops.splat_contributions(
            sub_cfg, glob_cfg, max_fuse_blocks, st,
            torch.as_tensor(life["base_R"], device=dev),
            torch.as_tensor(life["base_T"], device=dev))
        return fuse_contributions(glob_cfg, mesh, gstate, c)

    return fuse
