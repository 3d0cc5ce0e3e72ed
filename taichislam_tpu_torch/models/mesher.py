"""MarchingCubeMesher: host-facing mesher with the reference API.

Counterpart of the JAX package's ``models/mesher.py``:
``MarchingCubeMesher(mapping, max_triangles, tsdf_surface_thres)``,
``generate_mesh(step)``, ``vertice_num()`` and the flat host arrays
``mesh_vertices`` / ``mesh_colors`` / ``mesh_normals``.

Incremental re-mesh: the map keeps the union of TSDF-touched blocks since
the last mesh (``consume_mesh_dirty``); the mesher re-extracts only the
26-dilation of that set and patches the per-block triangle spans of a
persistent host buffer in place. Patched spans equal the same blocks in a
full extraction (the extraction reads the whole map for corners and
normals). Freed or shrunk spans become degenerate triangles; the buffer is
compacted when allocation runs past its end. Events that can move any
voxel (reset, load, submap switch) force a full extraction.

Delivery: "quantized" brings the mesh to the host as one 12-byte/vertex
buffer (0.5 mm vertices); "f32" copies the raw arrays. Maps whose extent
exceeds the int16 millimetre range always take "f32".
"""

from __future__ import annotations

import numpy as np
import torch

from taichislam_tpu_torch.ops import marching_cubes as mc_ops
from taichislam_tpu_torch.utils.profiling import host_read


class MarchingCubeMesher:
    def __init__(self, mapping, max_triangles=1000000,
                 tsdf_surface_thres=0.1, surface_block_cap=2048,
                 delivery="quantized", incremental=True):
        self.mapping = mapping
        self.max_triangles = max_triangles
        self.tsdf_surface_thres = tsdf_surface_thres
        self.surface_block_cap = min(surface_block_cap,
                                     mapping.cfg.max_blocks)
        self.enable_texture = mapping.enable_texture
        cfg = mapping.cfg
        half_extent = max(cfg.grid.bn_xy, cfg.grid.bn_z) * \
            cfg.num_voxel_per_blk_axis * cfg.voxel_scale / 2.0
        self.delivery = delivery if half_extent < 32.7 else "f32"
        self.num_facelets = 0
        self.total_triangles = 0
        n = max_triangles * 3
        self.mesh_vertices = np.full((n, 3), -1000000.0, np.float32)
        self.mesh_colors = np.full((n, 3), 0.5, np.float32)
        self.mesh_normals = np.zeros((n, 3), np.float32)
        self.mesh_indices = None
        # incremental state: per-block triangle spans over the persistent
        # buffer (slot -> [start_tri, cap_tri, count_tri])
        self.incremental = incremental
        self._spans = {}
        self._alloc_end = 0
        self._live_tris = 0
        self._have_base = False
        self._inc_block_cap = 64
        self._inc_mt = 1 << 12
        self._mt_bucket = 1 << 14

    def generate_mesh(self, step=1):
        if self.incremental and int(step) == 1:
            needs_full, dirty = self.mapping.consume_mesh_dirty()
            if not needs_full and self._have_base:
                if dirty is not None:
                    self._generate_mesh_incremental(dirty)
                return
        self._generate_mesh_full(step)

    def vertice_num(self):
        return self.num_facelets * 3

    def _extract(self, mt, step, cap, block_mask=None):
        m = self.mapping
        out = mc_ops.extract_mesh(m.cfg, mt, int(step), cap, m.state,
                                  m.active_submap_id,
                                  self.tsdf_surface_thres,
                                  block_mask=block_mask)
        tail = [] if block_mask is None else [block_mask.to(torch.int32)]
        # one host read: the counters, the per-block spans (and the mask)
        pack = host_read("mesh.counts", torch.cat([torch.stack([
            out["num_triangles"], out["total_triangles"],
            out["surface_blocks_dropped"], out["num_surface_blocks"]]),
            out["block_slots"], out["block_tri_counts"]] + tail)).numpy()
        return out, pack

    @staticmethod
    def _rows(n_tri, mt):
        rows = 1 << 8
        while rows < n_tri * 3:
            rows *= 2
        return min(rows, mt * 3)

    def _fetch(self, out, rows):
        """The first ``rows`` mesh rows as host arrays."""
        if self.delivery == "quantized":
            buf = mc_ops.pack_mesh_delivery(out["vertices"], out["normals"],
                                            out["colors"], rows,
                                            self.enable_texture)
            return mc_ops.unpack_mesh_delivery(buf, rows,
                                               self.enable_texture)
        return tuple(host_read("mesh.rows", out[k][:rows]).numpy()
                     for k in ("vertices", "normals", "colors"))

    # -- full extraction (+ the spans that seed the incremental path) -----
    def _generate_mesh_full(self, step=1):
        nblocks = int(host_read("mesh.block_count",
                                self.mapping.state.num_blocks)) + 1
        cap = 64
        while cap < nblocks:
            cap *= 2
        cap = min(cap, self.surface_block_cap)
        mt = min(self._mt_bucket, self.max_triangles)
        while True:
            out, pack = self._extract(mt, step, cap)
            n_tri, total, dropped, bkept = (int(x) for x in pack[:4])
            if total > mt and mt < self.max_triangles:
                while mt < min(total, self.max_triangles):
                    mt *= 2
                mt = min(mt, self.max_triangles)
                continue
            break
        self._mt_bucket = mt
        if dropped > 0:
            print(f"[Mesher] surface block cap hit: {dropped} dropped")
        self.num_facelets = n_tri
        self.total_triangles = total
        v, nrm, col = self._fetch(out, self._rows(n_tri, mt))
        v[n_tri * 3:] = -1000000.0   # the live prefix is [:num_facelets*3]
        self.mesh_vertices, self.mesh_normals, self.mesh_colors = v, nrm, col
        if total > self.max_triangles:
            print(f"[Mesher] triangle cap hit: {total} > "
                  f"{self.max_triangles}")

        self._spans = {}
        self._alloc_end = n_tri
        self._live_tris = n_tri
        self._have_base = (self.incremental and int(step) == 1 and
                           dropped == 0 and total <= mt)
        if self._have_base:
            slots_np = pack[4:4 + cap]
            counts_np = pack[4 + cap:4 + 2 * cap]
            starts = np.cumsum(counts_np) - counts_np
            for i in range(bkept):
                c = int(counts_np[i])
                if c > 0:
                    self._spans[int(slots_np[i])] = [int(starts[i]), c, c]

    # -- incremental re-mesh -------------------------------------------------
    def _generate_mesh_incremental(self, dirty):
        m = self.mapping
        dil = mc_ops.dilate_blocks(m.cfg, m.state, m.active_submap_id, dirty)
        cap = self._inc_block_cap
        mt = self._inc_mt
        while True:
            out, pack = self._extract(mt, 1, cap, block_mask=dil)
            n_tri, total, dropped, bkept = (int(x) for x in pack[:4])
            if dropped > 0 and cap < self.surface_block_cap:
                while cap < min(cap + dropped, self.surface_block_cap):
                    cap *= 2
                cap = min(cap, self.surface_block_cap)
                continue
            if total > mt and mt < self.max_triangles:
                while mt < min(total, self.max_triangles):
                    mt *= 2
                mt = min(mt, self.max_triangles)
                continue
            break
        self._inc_block_cap = cap
        self._inc_mt = mt
        if dropped > 0 or total > self.max_triangles:
            # cannot patch coherently at the caps: extract in full
            self._have_base = False
            self._generate_mesh_full(1)
            return
        slots_np = pack[4:4 + cap]
        counts_np = pack[4 + cap:4 + 2 * cap]
        dil_np = pack[4 + 2 * cap:].astype(bool)
        v, nrm, col = self._fetch(out, self._rows(max(n_tri, 1), mt))

        starts = np.cumsum(counts_np) - counts_np
        new = {int(slots_np[i]): (int(starts[i]), int(counts_np[i]))
               for i in range(bkept)}
        # blocks of the dilated set whose surface vanished
        for slot in [s for s in self._spans if dil_np[s] and s not in new]:
            self._free_span(slot)
        for slot, (off, cnt) in new.items():
            if cnt == 0:
                if slot in self._spans:
                    self._free_span(slot)
                continue
            rs, re = off * 3, (off + cnt) * 3
            if not self._write_span(slot, cnt, v[rs:re], nrm[rs:re],
                                    col[rs:re]):
                # buffer exhausted even after compaction
                self._have_base = False
                self._generate_mesh_full(1)
                return
        self.num_facelets = self._alloc_end
        self.total_triangles = self._live_tris

    # -- span buffer management ----------------------------------------------
    def _buf_tris(self):
        return len(self.mesh_vertices) // 3

    def _degenerate_fill(self, start, n):
        """Zero-area triangles (three coincident vertices at the -1e6 fill)
        for freed spans and the slack inside span caps."""
        if n <= 0:
            return
        sl = slice(start * 3, (start + n) * 3)
        self.mesh_vertices[sl] = -1000000.0
        self.mesh_normals[sl] = 0.0
        self.mesh_colors[sl] = 0.5

    def _free_span(self, slot):
        start, capt, cnt = self._spans.pop(slot)
        self._degenerate_fill(start, capt)
        self._live_tris -= cnt

    def _grow_buffer(self, need_tris):
        rows = len(self.mesh_vertices)
        want = max(rows, 1 << 8)
        while want < need_tris * 3:
            want *= 2
        want = min(want, self.max_triangles * 3)
        if want <= rows:
            return False
        pad = want - rows
        self.mesh_vertices = np.concatenate(
            [self.mesh_vertices, np.full((pad, 3), -1000000.0, np.float32)])
        self.mesh_normals = np.concatenate(
            [self.mesh_normals, np.zeros((pad, 3), np.float32)])
        self.mesh_colors = np.concatenate(
            [self.mesh_colors, np.full((pad, 3), 0.5, np.float32)])
        return True

    def _compact_buffer(self):
        """Slide the live spans to the front with tight caps."""
        pos = 0
        for slot, sp in sorted(self._spans.items(), key=lambda kv: kv[1][0]):
            start, _, cnt = sp
            if start != pos:
                for buf in (self.mesh_vertices, self.mesh_normals,
                            self.mesh_colors):
                    buf[pos * 3:(pos + cnt) * 3] = \
                        buf[start * 3:(start + cnt) * 3].copy()
            sp[0], sp[1] = pos, cnt
            pos += cnt
        if pos < self._alloc_end:
            self._degenerate_fill(pos, self._alloc_end - pos)
        self._alloc_end = pos

    def _write_span(self, slot, cnt, v, nrm, col):
        sp = self._spans.get(slot)
        if sp is not None and cnt <= sp[1]:
            start, capt, old = sp
            s3 = start * 3
            self.mesh_vertices[s3:s3 + cnt * 3] = v
            self.mesh_normals[s3:s3 + cnt * 3] = nrm
            self.mesh_colors[s3:s3 + cnt * 3] = col
            self._degenerate_fill(start + cnt, capt - cnt)
            sp[2] = cnt
            self._live_tris += cnt - old
            return True
        if sp is not None:
            self._free_span(slot)
        capt = 16
        while capt < cnt:
            capt *= 2
        if self._alloc_end + capt > self._buf_tris():
            if not self._grow_buffer(self._alloc_end + capt):
                self._compact_buffer()
                if self._alloc_end + capt > self._buf_tris() and \
                        not self._grow_buffer(self._alloc_end + capt):
                    return False
        start = self._alloc_end
        self._alloc_end += capt
        self._spans[slot] = [start, capt, cnt]
        s3 = start * 3
        self.mesh_vertices[s3:s3 + cnt * 3] = v
        self.mesh_normals[s3:s3 + cnt * 3] = nrm
        self.mesh_colors[s3:s3 + cnt * 3] = col
        self._degenerate_fill(start + cnt, capt - cnt)
        self._live_tris += cnt
        return True
