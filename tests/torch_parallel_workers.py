"""Rank workers of the port's parallel parity tests.

``spawn_mesh`` children import this module to find their function, so it
imports no JAX and nothing of the JAX package: each worker runs the port on
its rank (gloo on the CPU) and returns numpy arrays, gathered where they
are sharded, for the test to hold against JAX and against one rank.
"""

import numpy as np

K = np.asarray([20.0, 0, 16.0, 0, 20.0, 12.0, 0, 0, 1], np.float32)


def _t(a, dtype=None):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))


def mesh_device(mesh):
    return str(mesh.device)


def collectives(mesh):
    """Each collective on rank-dependent data."""
    import torch
    r = mesh.rank
    x = torch.arange(3, dtype=torch.float32) + 10 * r
    b = torch.tensor([r == 0, r == 1, False])
    i8 = torch.full((2, 2), r + 1, dtype=torch.int8)
    return dict(rank=mesh.axis_index(), size=mesh.size,
                gather=mesh.all_gather(x.view(3, 1)).numpy(),
                gather_b=mesh.all_gather(b).numpy(),
                gather_i8=mesh.all_gather(i8).numpy(),
                psum=mesh.psum(x).numpy(), psum_i8=mesh.psum(i8).numpy(),
                any=mesh.any(b).numpy())


def fail_on_rank(mesh, bad):
    import torch
    if mesh.rank == bad:
        raise ValueError(f"rank {bad} fails")
    mesh.psum(torch.zeros(1))    # the others wait on the failed rank


def sharded_integrate(mesh, kw, frames, cap):
    """The sharded integrate over ``frames`` (depth, texture, R, T), then
    the surface gather at ``cap``: the gathered state, the touched bitmaps
    and the mini state."""
    from taichislam_tpu_torch import bridge
    from taichislam_tpu_torch.core.config import TSDFConfig
    from taichislam_tpu_torch.ops import tsdf as tt
    from taichislam_tpu_torch.parallel.block_sharded import (
        gather_surface_blocks, shard_state, sharded_integrate_depth,
        unshard_state)
    cfg = TSDFConfig(**kw)
    state = shard_state(tt.make_tsdf_state(cfg, device="cpu"), mesh)
    step = sharded_integrate_depth(cfg, mesh)
    touched = []
    for depth, tex, R, T in frames:
        state, t = step(state, _t(depth, np.int32), _t(tex), _t(R), _t(T),
                        _t(K), _t(K), 0)
        touched.append(t.numpy())
    mini, n_kept, ov = gather_surface_blocks(cfg, mesh, cap)(state, 0)
    return dict(state=bridge.grid_state_to_numpy(unshard_state(state, mesh)),
                touched=touched, mini=bridge.grid_state_to_numpy(mini),
                n_kept=int(n_kept), overflow=int(ov))


def sharded_esdf(mesh, kw, steps, sweeps, cap, incremental):
    """The sharded ESDF update on each of ``steps``: (full state, previous
    field, previous flags, dirty bitmap or None) as numpy, carried in.
    Returns the gathered outputs and the overflow the pre-check gave."""
    import torch
    from taichislam_tpu_torch import bridge
    from taichislam_tpu_torch.core.config import TSDFConfig
    from taichislam_tpu_torch.parallel.sharded_esdf import \
        sharded_esdf_update
    cfg = TSDFConfig(**kw)
    fn = sharded_esdf_update(cfg, sweeps, cap, mesh, incremental)
    outs = []
    for st_np, e, f, dirty in steps:
        st = bridge.sharded_state_from_numpy(st_np, mesh)
        pe = bridge.sharded_rows_from_numpy(e, mesh)
        pf = bridge.sharded_rows_from_numpy(f, mesh)
        args = (st, pe, pf, 0) + ((torch.from_numpy(dirty.copy()),)
                                  if incremental
                                  else ())
        pre = fn.overflow(*args[:1], 0, *args[4:])
        e2, f2, obs, sw, ch, ov = fn(*args)
        outs.append(dict(esdf=mesh.all_gather(e2).numpy(),
                         fixed=mesh.all_gather(f2).numpy(),
                         obs=mesh.all_gather(obs).numpy(), sweeps=int(sw),
                         changed=ch.numpy(), overflow=int(ov),
                         overflow_pre=pre))
    return outs


def drone_step(mesh, sub_kw, glob_kw, depth, R, T, base_R, base_T,
               fuse_blocks):
    """multi_drone_step on this rank's drone: its state and the global
    map."""
    from taichislam_tpu_torch import bridge
    from taichislam_tpu_torch.core.config import TSDFConfig
    from taichislam_tpu_torch.ops import tsdf as tt
    from taichislam_tpu_torch.parallel.multi_drone import (
        make_drone_states, multi_drone_step)
    sub, glob = TSDFConfig(**sub_kw), TSDFConfig(**glob_kw)
    d = mesh.rank
    st = make_drone_states(sub, device="cpu")
    g = tt.make_tsdf_state(glob, device="cpu")
    st, g = multi_drone_step(sub, glob, fuse_blocks, mesh)(
        st, g, _t(depth[d], np.int32), _t(R[d]), _t(T[d]), _t(K),
        _t(base_R), _t(base_T))
    return dict(state=bridge.grid_state_to_numpy(st),
                glob=bridge.grid_state_to_numpy(g))


def drone_lifecycle(mesh, sub_kw, glob_kw, depths, Rs, Ts, kstep, sweeps,
                    cap, triangles, bcap, fuse_blocks):
    """multi_drone_lifecycle_step over every frame for this rank's drone
    (ESDF when ``sweeps``, mesh patch when ``triangles``), then
    multi_drone_fuse when ``fuse_blocks``."""
    from taichislam_tpu_torch import bridge
    from taichislam_tpu_torch.core.config import TSDFConfig
    from taichislam_tpu_torch.ops import tsdf as tt
    from taichislam_tpu_torch.parallel.multi_drone import (
        make_lifecycle_states, multi_drone_fuse, multi_drone_lifecycle_step)
    sub = TSDFConfig(**sub_kw)
    life = make_lifecycle_states(sub, with_esdf=bool(sweeps), device="cpu")
    step = multi_drone_lifecycle_step(
        sub, kstep, mesh, esdf_sweeps=sweeps or None,
        esdf_block_cap=cap, mesh_triangles=triangles or None,
        mesh_block_cap=bcap)
    patch = None
    d = mesh.rank
    for f in range(len(depths)):
        out = step(life, _t(depths[f][d], np.int32), Rs[f][d], Ts[f][d],
                   True, _t(K))
        life, patch = out if triangles else (out, None)
    res = dict(state=bridge.grid_state_to_numpy(life["state"]),
               active=life["active"], fcount=life["fcount"],
               base_R=life["base_R"], base_T=life["base_T"])
    if sweeps:
        for k in ("esdf", "fixed", "pending", "esdf_stats"):
            res[k] = life[k].numpy()
    if triangles:
        res["vertices"] = patch["vertices"].numpy()
        res["counts"] = patch["counts"].numpy()
    if fuse_blocks:
        glob = TSDFConfig(**glob_kw)
        g = multi_drone_fuse(sub, glob, fuse_blocks, mesh,
                             with_esdf=bool(sweeps))(
            life, tt.make_tsdf_state(glob, device="cpu"))
        res["glob"] = bridge.grid_state_to_numpy(g)
    return res


def sharded_model(mesh, kw, frames):
    """ShardedDenseTSDF over ``frames`` (depth, R, T): per frame the
    gathered TSDF, field and sweeps; at the end the surface export, the
    incremental mesh patch (twice: the second is empty), count_active and
    the ESDF dict's size."""
    from taichislam_tpu_torch import bridge
    from taichislam_tpu_torch.models.sharded_dense_tsdf import \
        ShardedDenseTSDF
    from taichislam_tpu_torch.parallel.block_sharded import unshard_state
    m = ShardedDenseTSDF(mesh=mesh, **kw)
    m._esdf_cap_bucket = m.esdf_block_cap
    m.set_dep_camera_intrinsic(K)
    per = []
    for depth, R, T in frames:
        m.recast_depth_to_map(R, T, depth)
        per.append(dict(
            state=bridge.grid_state_to_numpy(unshard_state(m.state, mesh)),
            esdf=mesh.all_gather(m.esdf).numpy(),
            fixed=mesh.all_gather(m.esdf_fixed).numpy(),
            pending=m._esdf_pending.numpy(), sweeps=m.last_esdf_sweeps))
    m.cvt_TSDF_surface_to_voxels()
    out = m.extract_mesh(incremental=True)
    nt = int(out["num_triangles"])
    again = int(m.extract_mesh(incremental=True)["num_triangles"])
    return dict(per=per, xyz=m.export_TSDF_xyz, tsdf=m.export_TSDF,
                n_surface=m.num_TSDF_particles,
                vertices=out["vertices"][:nt * 3].numpy(), again=again,
                count_active=m.count_active(),
                esdf_dict=len(m.get_esdf_dict()), cfg_V=m.cfg.grid.V,
                max_blocks=m.cfg.max_blocks)
