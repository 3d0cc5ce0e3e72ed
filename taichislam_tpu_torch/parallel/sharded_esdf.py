"""Incremental ESDF on a block-sharded map.

Counterpart of the JAX package's ``parallel/sharded_esdf.py``. The
persistent ESDF state — the ``(max_blocks+1, V^3)`` f32 field and int8
fixed flags — is split over the slot axis like the TSDF channels
(``parallel/block_sharded.py``), and each update runs as a collective:

- **working set by a sum of disjoint shard scatters**: the compacted rows
  (dirty blocks and their frozen rim, the policy of ``ops.esdf.esdf_update``)
  are assembled by every rank scattering the rows it owns into a zeroed
  compact buffer and one sum over ranks; each row has one writer, so the
  sum is exact;
- **row chunks with an all_gather halo exchange**: the compact rows are
  padded to ``NROWS = ceil((cap+1)/(8n))·8n`` and split into ``n`` equal
  chunks, one per rank. Each sweep all-gathers the chunks, fills the halo
  shells from neighbour rows (``ops.esdf._assemble_sweep``) on the whole
  compact field, and runs K2 (``ops/kernels/esdf_sweep.py::esdf_sweep``,
  no slab gate) on this rank's rows only. The loop continues while any
  rank's chunk changed;
- **scatter-back to shard rows**: each rank writes back the compact rows
  whose slot falls in its shard; the re-queue bitmap and the overflow are
  replicated, as the single-device update returns them.

Every sweep computes what the single-device K3 loop computes for the same
rows (its gates skip only unchanged rows), so field, flags, sweep count and
re-queue bitmap equal ``ops.esdf.esdf_update``'s. The JAX function's XLA
sweep body is not ported: the port always runs the kernel (its
``pallas="on"``), and ``pallas`` is accepted for name compatibility only.
"""

from __future__ import annotations

import numpy as np
import torch

from taichislam_tpu_torch.core.config import TSDFConfig
from taichislam_tpu_torch.ops.esdf import (_assemble_sweep,
                                           _from_sweep_layout,
                                           _to_sweep_layout, requeue,
                                           scan_this_sweep, seed_field,
                                           slab_rows, sweep_kw,
                                           update_sides, working_set)
from taichislam_tpu_torch.ops.kernels.esdf_sweep import ENC_BIG, esdf_sweep
from taichislam_tpu_torch.parallel.block_sharded import _shard_rows
from taichislam_tpu_torch.parallel.mesh import Mesh


def esdf_sharding(mesh: Mesh, axis: str = "block") -> str:
    """Placement of (esdf, fixed): split on the slot axis like the
    channels, so this rank holds ``(max_blocks+1)/mesh.size`` rows."""
    return axis


def sharded_esdf_update(cfg: TSDFConfig, max_sweeps: int, block_cap: int,
                        mesh: Mesh, incremental: bool, axis: str = "block",
                        pallas: str = "auto"):
    """The collective ESDF update over a slot-sharded map:
    ``fn(state, prev_esdf, prev_fixed, active_submap, dirty_blocks)``
    (``incremental=True``) or ``fn(state, prev_esdf, prev_fixed,
    active_submap)``.

    ``state`` is this rank's sharded GridState, ``prev_esdf`` /
    ``prev_fixed`` this rank's (rows, V^3) parts of the field and flags
    (updated in place), ``dirty_blocks`` the replicated (max_blocks+1,)
    bitmap (the touched bitmap of ``sharded_integrate_depth`` OR'd with the
    previous call's re-queue bitmap).

    Returns (esdf, fixed, observed, sweeps, changed_blocks, overflow): the
    first three this rank's rows, the rest replicated, with the semantics
    of ``ops.esdf.esdf_update``."""
    spec = cfg.grid
    V = spec.V
    shard_rows = _shard_rows(spec.max_blocks + 1, mesh)
    n = mesh.size
    cap = block_cap
    NROWS = slab_rows(cap, n)
    m = NROWS // n
    conv = float(np.float32(cfg.esdf_converge_eps))
    kw = sweep_kw(cfg)

    def local(state, prev_esdf, prev_fixed, active_submap, dirty_blocks=None):
        me = mesh.rank
        lo = me * shard_rows
        dev = prev_esdf.device
        ws = working_set(spec, state, active_submap, cap, NROWS,
                         dirty_blocks if incremental else None)
        blk_l = ws.blk[lo:lo + shard_rows]

        # compact rows: each rank scatters the rows it owns, one sum
        inv_l = ws.inv[lo:lo + shard_rows]
        own = torch.nonzero(inv_l < cap).squeeze(1)
        part_l = (state.channels["TSDF_observed"] > 0) & blk_l[:, None]
        z = torch.zeros((NROWS, 4, spec.voxels_per_block),
                        dtype=torch.float32, device=dev)
        z[inv_l[own].long()] = torch.stack(
            [state.channels["TSDF"][own].float(), part_l[own].float(),
             prev_esdf[own].float(), prev_fixed[own].float()], dim=1)
        comp = mesh.psum(z)
        tsdf = comp[:, 0]
        participate = comp[:, 1] > 0
        prev_e = comp[:, 2].contiguous()
        prev_f = comp[:, 3].to(torch.int32)
        fixed, esdf0 = seed_field(cfg, tsdf, participate, prev_e, prev_f)

        chunk = slice(me * m, (me + 1) * m)
        enc_c = _assemble_sweep(_to_sweep_layout(
            torch.where(participate, tsdf, ENC_BIG), V, ENC_BIG), ws.nslots,
            V)[chunk].contiguous()
        side_c = update_sides(ws, V, tsdf, participate, fixed)[chunk] \
            .contiguous()
        esdf_mine = _to_sweep_layout(esdf0, V, 0.0)[chunk].contiguous()
        sweeps = 0
        changed = True
        while changed and sweeps < max_sweeps:
            # the gathered field is a new tensor: the halo fill writes it,
            # never this rank's chunk
            eh_c = _assemble_sweep(mesh.all_gather(esdf_mine), ws.nslots,
                                   V)[chunk].contiguous()
            new = esdf_sweep(eh_c, enc_c, side_c, None,
                             with_scans=scan_this_sweep(cfg, sweeps), **kw)
            changed = bool(mesh.any(((new - eh_c).abs() > conv).any())) or \
                cfg.esdf_force_sweeps
            esdf_mine = new
            sweeps += 1
        esdf_c = _from_sweep_layout(mesh.all_gather(esdf_mine), V)

        # scatter-back: each rank writes its own shard's rows
        slot_l = ws.slot_of.long()
        upd = ws.updatable[:cap] & (slot_l >= lo) & \
            (slot_l < lo + shard_rows)
        sel = torch.nonzero(upd).squeeze(1)
        rows = slot_l[sel] - lo
        prev_esdf[rows] = torch.where(participate[sel], esdf_c[sel], 0.0)
        prev_fixed[rows] = (participate[sel] & fixed[sel]).to(
            prev_fixed.dtype)
        cb = requeue(cfg, ws, esdf_c, prev_e, fixed, prev_f, incremental)
        return (prev_esdf, prev_fixed, part_l,
                torch.tensor(sweeps, dtype=torch.int32, device=dev), cb,
                ws.overflow)

    def overflow(state, active_submap, dirty_blocks=None) -> int:
        """The working-set overflow a call would report, from the
        replicated bookkeeping alone (one host read): a caller that grows
        the cap on overflow asks before the call, which writes the field
        in place."""
        return int(working_set(spec, state, active_submap, cap, NROWS,
                               dirty_blocks if incremental else None)
                   .overflow)

    if incremental:
        fn = local
    else:
        def fn(state, prev_esdf, prev_fixed, active_submap):
            return local(state, prev_esdf, prev_fixed, active_submap)
    fn.overflow = overflow
    return fn
