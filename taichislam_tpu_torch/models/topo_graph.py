"""Topological skeleton-graph generation over a TSDF or occupancy map.

Counterpart of the JAX package's ``models/topo_graph.py`` ("Fast 3D Sparse
Topological Skeleton Graph Generation"): polyhedra grown over free space
from a seed, with frontier-driven growth.

- ``node_expansion``: a Fibonacci-sphere fan of ``coll_det_num`` rays from
  a seed against both the map and every installed polyhedron facelet; the
  hits ("black") are scaled onto their hit distance and the convex hull of
  the hit directions (scipy, float64) becomes the node polyhedron.
- a facelet is a frontier when its centre is observed and free and a
  forward raycast within ``frontier_creation_threshold`` hits nothing;
  frontier facelets are clustered by BFS over the hull adjacency where
  their normals agree within ``frontier_combine_angle_threshold``, and the
  cluster mean is projected onto a member facelet (Moller-Trumbore).
- ``verify_frontier``: a two-sided collision check; survivors seed the
  next node at half the free distance.

The map interaction runs on the map's device (``ops/raycast.py``), batched
and packed into one f32 buffer per call, so each call costs one host read
(``host_syncs`` counts them since ``reset``). The hull, the facelet
arrays, the BFS clustering and the graph state are host numpy, as in the
JAX package: a few hundred facelets per node.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from scipy.spatial import ConvexHull

from taichislam_tpu_torch.models.octomap import Octomap
from taichislam_tpu_torch.ops import raycast as rc_ops


def _is_octo(m) -> bool:
    return isinstance(m, Octomap)


def _packed_map_raycast(m, steps: int, pos, dirs, maxd):
    """Map raycast packed into one f32 buffer [hit | length | hit_pos]."""
    fn = rc_ops.octomap_raycast if _is_octo(m) else rc_ops.tsdf_raycast
    hit, hp, hl = fn(m.cfg, steps, m.state, m.active_submap_id, pos, dirs,
                     maxd)
    return torch.cat([hit.float(), hl.float(), hp.float().reshape(-1)])


def _packed_map_query(m, xyz):
    """Point query packed into one buffer [occupied | unobserved]."""
    fn = rc_ops.octomap_point_query if _is_octo(m) else \
        rc_ops.tsdf_point_query
    occ, unobs = fn(m.cfg, m.state, m.active_submap_id, xyz)
    return torch.cat([occ.float(), unobs.float()])


def _packed_facelet_checks(m, steps: int, centers, starts, normals, maxd):
    """add_mesh's whole map interaction in one buffer: the centre and start
    point queries and the frontier-creation forward raycast of every
    facelet, [unobserved centre | occupied start | hit | length]."""
    octo = _is_octo(m)
    qfn = rc_ops.octomap_point_query if octo else rc_ops.tsdf_point_query
    rfn = rc_ops.octomap_raycast if octo else rc_ops.tsdf_raycast
    sid = m.active_submap_id
    _, unobs_c = qfn(m.cfg, m.state, sid, centers)
    occ_s, _ = qfn(m.cfg, m.state, sid, starts)
    hit, _, hl = rfn(m.cfg, steps, m.state, sid, starts, normals, maxd)
    return torch.cat([unobs_c.float(), occ_s.float(), hit.float(),
                      hl.float()])


def fibonacci_sphere(npoints: int) -> np.ndarray:
    """Uniform unit directions (golden-angle spiral)."""
    phi = np.pi * (3 - np.sqrt(5))
    i = np.arange(npoints)
    y = 1 - 2 * (i / (npoints - 1))
    radius = np.sqrt(np.maximum(1 - y * y, 0.0))
    theta = phi * i
    return np.stack([np.cos(theta) * radius, y, np.sin(theta) * radius],
                    -1).astype(np.float32)


def _moller_trumbore(v0, e1, e2, P, w):
    """Batched ray/triangle intersection with the reference's
    unnormalized-parameter quirks: s = (P - v0)/a (a vector divided by the
    determinant), barycentric checks on b0/b1/b2 and unbounded t."""
    q = np.cross(w, e2)
    a = np.einsum("fd,fd->f", e1, q)
    ok = np.abs(a) > 1e-5
    a_safe = np.where(ok, a, 1.0)
    s = (P - v0) / a_safe[:, None]
    r = np.cross(s, e1)
    b0 = np.einsum("fd,fd->f", s, q)
    b1 = np.einsum("fd,fd->f", r, np.broadcast_to(w, v0.shape))
    b2 = 1.0 - b0 - b1
    t = np.einsum("fd,fd->f", e2, r)
    succ = ok & (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
    return succ, t


def _moller_trumbore_fan(v0, e1, e2, P, w):
    """(R rays) x (F facelets) intersection in one vectorized pass, the
    math and quirks of :func:`_moller_trumbore` broadcast to (R, F). ``P``
    is (3,) (shared origin) or (R, 3); ``w`` is (R, 3)."""
    q = np.cross(w[:, None, :], e2[None, :, :])          # (R, F, 3)
    a = np.einsum("fd,rfd->rf", e1, q)
    ok = np.abs(a) > 1e-5
    a_safe = np.where(ok, a, 1.0)
    P2 = P[None, None, :] if P.ndim == 1 else P[:, None, :]
    s = (P2 - v0[None]) / a_safe[..., None]              # (R, F, 3)
    r = np.cross(s, e1[None])
    b0 = np.einsum("rfd,rfd->rf", s, q)
    b1 = np.einsum("rfd,rd->rf", r, w)
    b2 = 1.0 - b0 - b1
    t = np.einsum("fd,rfd->rf", e2, r)
    succ = ok & (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
    return succ, t


class TopoGraphGen:
    def __init__(self, mapping, coll_det_num=128, max_raycast_dist=2,
                 max_facelets=1024 * 1024, thres_size=0.5, transparent=0.7,
                 transparent_frontier=0.6, frontier_creation_threshold=0.5,
                 frontier_verify_threshold=0.5, frontier_backward_check=-0.2,
                 frontier_combine_angle_threshold=40):
        self.mapping = mapping
        self.coll_det_num = coll_det_num
        self.sample_dirs = fibonacci_sphere(coll_det_num)
        self.max_raycast_dist = max_raycast_dist
        self.max_facelets = max_facelets
        self.thres_size = thres_size
        self.frontier_creation_threshold = frontier_creation_threshold
        self.frontier_verify_threshold = frontier_verify_threshold
        self.frontier_backward_check = frontier_backward_check
        self.frontier_normal_dot_threshold = float(
            np.cos(np.deg2rad(frontier_combine_angle_threshold)))
        self.check_frontier_small_distance = 0.1
        self.transparent = transparent
        self.transparent_frontier = transparent_frontier

        rng = np.random.default_rng(0)
        self.colormap = rng.random((4096, 4)).astype(np.float32)
        self.colormap[:, 3] = transparent
        self.reset()

    @property
    def device(self) -> torch.device:
        """The device of the map the graph reads (its queries run there)."""
        return self.mapping.device

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def reset(self):
        self.fl_v0 = np.zeros((0, 3), np.float32)
        self.fl_e1 = np.zeros((0, 3), np.float32)
        self.fl_e2 = np.zeros((0, 3), np.float32)
        self.fl_normal = np.zeros((0, 3), np.float32)
        self.fl_center = np.zeros((0, 3), np.float32)
        self.fl_poly = np.zeros((0,), np.int32)
        self.fl_frontier = np.zeros((0,), bool)
        self.nodes = []          # dicts: start, end, center, master
        self.frontiers = []      # dicts
        self.edges = []          # (a, b) endpoints
        self.edge_colors = []
        self.connected = set()   # (i, j) pairs
        self.search_frontiers_idx = 0
        self.tri_colors = np.zeros((0, 4), np.float32)
        self.host_syncs = 0      # packed map calls (one host read each)

    @property
    def num_facelets(self):
        return len(self.fl_v0)

    @property
    def num_nodes(self):
        return len(self.nodes)

    @property
    def num_frontiers(self):
        return len(self.frontiers)

    @property
    def tri_vertices(self):
        out = np.empty((self.num_facelets * 3, 3), np.float32)
        out[0::3] = self.fl_v0
        out[1::3] = self.fl_v0 + self.fl_e1
        out[2::3] = self.fl_v0 + self.fl_e2
        return out

    # ------------------------------------------------------------------
    # map interaction (batched, on the map's device)
    # ------------------------------------------------------------------
    def _dev(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _fetch(self, buf):
        """The one host read of a packed map call."""
        self.host_syncs += 1
        return buf.cpu().numpy()

    def _map_raycast(self, pos, dirs, max_dist):
        m = self.mapping
        steps = int(np.ceil((max_dist) / m.voxel_scale)) + 1
        buf = self._fetch(_packed_map_raycast(
            m, steps, self._dev(pos), self._dev(dirs), self._dev(max_dist)))
        n = len(np.atleast_2d(dirs))
        return (buf[:n] > 0.5, buf[2 * n:].reshape(n, 3), buf[n:2 * n])

    def _map_query(self, xyz):
        buf = self._fetch(_packed_map_query(self.mapping, self._dev(xyz)))
        n = len(np.atleast_2d(xyz))
        return buf[:n] > 0.5, buf[n:] > 0.5

    def _facelet_raycast(self, pos, dirs, max_dist, backward_dist=-0.01,
                         skip_idx=-1):
        """Nearest facelet hit of each ray with t in (backward_dist,
        max_dist), skipping polyhedron ``skip_idx`` (host numpy)."""
        R = len(dirs)
        best_t = np.full(R, max_dist, np.float32)
        best_poly = np.full(R, -1, np.int32)
        succ = np.zeros(R, bool)
        keep = self.fl_poly != skip_idx
        if self.num_facelets and keep.any():
            v0, e1, e2 = self.fl_v0[keep], self.fl_e1[keep], self.fl_e2[keep]
            poly = self.fl_poly[keep]
            s, t = _moller_trumbore_fan(v0, e1, e2,
                                        np.asarray(pos, np.float32), dirs)
            s &= (t > backward_dist) & (t < max_dist)     # (R, F)
            any_hit = s.any(axis=1)
            i = np.argmin(np.where(s, t, np.inf), axis=1)
            rr = np.arange(R)
            best_t = np.where(any_hit, t[rr, i], best_t).astype(np.float32)
            best_poly = np.where(any_hit, poly[i], best_poly)
            succ = any_hit
        pos_b = pos if np.ndim(pos) == 1 else np.asarray(pos)
        return succ, pos_b + dirs * best_t[:, None], best_t, best_poly

    def raycast(self, pos, dirs, max_dist, skip_idx=-1):
        """Combined polyhedron + map raycast. Returns (succ, type (1 =
        polyhedron, 0 = map), pos, len, poly_idx), batched."""
        dirs = np.atleast_2d(np.asarray(dirs, np.float32))
        sp, pp, tp, ip = self._facelet_raycast(pos, dirs, max_dist,
                                               skip_idx=skip_idx)
        sm, pm, tm = self._map_raycast(pos, dirs, max_dist)
        # a map hit wins only below the polyhedron hit distance
        use_map = (~sp) | (sm & (tm < tp))
        succ = np.where(use_map, sm, sp)
        rtype = np.where(use_map, 0, 1)
        length = np.where(use_map, tm, tp)
        posn = np.where(use_map[:, None], pm, pp)
        return succ, rtype, posn, length, ip

    # ------------------------------------------------------------------
    # node expansion
    # ------------------------------------------------------------------
    def detect_collisions(self, start_pt):
        succ, rtype, posn, length, poly = self.raycast(
            np.asarray(start_pt, np.float32), self.sample_dirs,
            self.max_raycast_dist)
        black = succ
        self.black_dirs = self.sample_dirs[black]
        self.black_lens = length[black]
        self.white_num = int((~black).sum())
        self.black_num = int(black.sum())
        if self.black_num == 0:
            return False
        node_size = float(self.black_lens.sum()) / self.black_num
        if self.white_num == 0 and node_size < self.thres_size:
            return False
        return True

    def node_expansion(self, start_pt, show=False, last_node_idx=-1):
        start_pt = np.asarray(start_pt, np.float32)
        if self.detect_collisions(start_pt):
            self.generate_poly_on_blacks(start_pt, show, last_node_idx)

    def generate_poly_on_blacks(self, start_pt, show=False, last_node_idx=-1):
        hull = ConvexHull(self.black_dirs.astype(np.float64))
        verts = hull.points * self.black_lens[:, None] + np.asarray(start_pt)
        mesh = verts[hull.simplices].astype(np.float32)
        self.add_mesh(mesh, hull.neighbors, np.asarray(start_pt, np.float32),
                      last_node_idx)

    # ------------------------------------------------------------------
    # facelet installation + frontier construction
    # ------------------------------------------------------------------
    def add_mesh(self, mesh, neighbors, start_pt, last_node_idx=-1):
        F = len(mesh)
        start_idx = self.num_facelets
        node_idx = self.num_nodes
        v0, v1, v2 = mesh[:, 0], mesh[:, 1], mesh[:, 2]
        e1, e2 = v1 - v0, v2 - v0
        center = (v0 + v1 + v2) / 3
        normal = np.cross(e1, e2)
        normal /= np.maximum(np.linalg.norm(normal, axis=-1, keepdims=True),
                             1e-12)
        naive = center - start_pt
        flip = np.einsum("fd,fd->f", normal, naive) < 0
        normal[flip] = -normal[flip]

        # frontier detection: one packed map call covers the point queries
        # and the frontier-creation map raycast of all F facelets (the
        # reference's is_near_pos_occupy(center, 0) checks an empty range,
        # always False); the facelet half of the combined raycast is host
        start_rc = center + normal * self.mapping.voxel_scale
        m = self.mapping
        thr = self.frontier_creation_threshold
        steps = int(np.ceil(thr / m.voxel_scale)) + 1
        buf = self._fetch(_packed_facelet_checks(
            m, steps, self._dev(center), self._dev(start_rc),
            self._dev(normal), self._dev(thr)))
        unobs_c = buf[:F] > 0.5
        occ_s = buf[F:2 * F] > 0.5
        sm = buf[2 * F:3 * F] > 0.5
        tm = buf[3 * F:]
        candidate = (~unobs_c) & (~occ_s)
        is_frontier = np.zeros(F, bool)
        neighbor_nodes = []
        if candidate.any():
            idx = np.nonzero(candidate)[0]
            # combined with the live facelet raycast as in raycast(): a map
            # hit wins only below the facelet hit
            sp, _, tp, ip = self._facelet_raycast(start_rc[idx],
                                                  normal[idx], thr)
            use_map = (~sp) | (sm[idx] & (tm[idx] < tp))
            s = np.where(use_map, sm[idx], sp)
            is_frontier[idx[~s]] = True
            neighbor_nodes.extend(
                int(p) for p in ip[s & ~use_map])

        self.fl_v0 = np.concatenate([self.fl_v0, v0])
        self.fl_e1 = np.concatenate([self.fl_e1, e1])
        self.fl_e2 = np.concatenate([self.fl_e2, e2])
        self.fl_normal = np.concatenate([self.fl_normal, normal])
        self.fl_center = np.concatenate([self.fl_center, center])
        self.fl_poly = np.concatenate(
            [self.fl_poly, np.full(F, node_idx, np.int32)])
        self.fl_frontier = np.concatenate([self.fl_frontier, is_frontier])
        col = np.tile(self.colormap[node_idx % len(self.colormap)], (F * 3, 1))
        col[np.repeat(is_frontier, 3), 3] = self.transparent_frontier
        self.tri_colors = np.concatenate([self.tri_colors, col])

        node_center = center.mean(axis=0)
        self.nodes.append(dict(start=start_idx, end=start_idx + F,
                               center=node_center, master=last_node_idx))
        if last_node_idx >= 0:
            self._connect(node_idx, last_node_idx)
        for neigh in neighbor_nodes:
            self._connect(node_idx, neigh)

        # frontier clustering: BFS over the hull adjacency, normals agreeing
        assigned = np.zeros(F, bool)
        for i in range(F):
            if assigned[i] or not is_frontier[i]:
                continue
            seed_normal = normal[i]
            queue = [i]
            cluster = []
            assigned[i] = True
            while queue:
                cur = queue.pop(0)
                cluster.append(cur)
                for nb in neighbors[cur]:
                    if (is_frontier[nb] and not assigned[nb] and
                            float(seed_normal @ normal[nb]) >
                            self.frontier_normal_dot_threshold):
                        assigned[nb] = True
                        queue.append(nb)
            self._construct_frontier(node_idx, start_idx, cluster)

    def _connect(self, a, b):
        """Record the adjacency and a display edge between node centres."""
        if (a, b) not in self.connected:
            self.connected.add((a, b))
            self.connected.add((b, a))
            self.edges.append((self.nodes[b]["center"],
                               self.nodes[a]["center"]))
            self.edge_colors.append((np.zeros(3, np.float32),
                                     np.zeros(3, np.float32)))

    def _construct_frontier(self, node_idx, start_idx, cluster):
        ids = np.asarray(cluster, np.int64) + start_idx
        center = self.fl_center[ids].mean(axis=0)
        normal = self.fl_normal[ids].sum(axis=0)
        normal /= max(np.linalg.norm(normal), 1e-12)
        succ, t = _moller_trumbore(self.fl_v0[ids], self.fl_e1[ids],
                                   self.fl_e2[ids], center, normal)
        if not succ.any():
            return
        k = int(np.nonzero(succ)[0][0])
        proj_center = center + t[k] * normal
        projected_normal = self.fl_normal[ids[k]]
        self.frontiers.append(dict(
            master_idx=node_idx, avg_center=center,
            outwards_unit_normal=normal, projected_center=proj_center,
            projected_normal=projected_normal, next_node_initial=None,
            is_valid=False))

    # ------------------------------------------------------------------
    # frontier verification + graph growth
    # ------------------------------------------------------------------
    def verify_frontier(self, frontier_idx):
        fr = self.frontiers[frontier_idx]
        normal = fr["projected_normal"]
        pc = fr["projected_center"] + \
            normal * self.check_frontier_small_distance
        sm, _, tm = self._map_raycast(pc[None].astype(np.float32),
                                      normal[None].astype(np.float32),
                                      self.max_raycast_dist * 2)
        return self._verify_frontier_cached(frontier_idx, bool(sm[0]),
                                            float(tm[0]))

    def _verify_frontier_cached(self, frontier_idx, map_succ, map_t):
        """verify_frontier with the map half of the forward raycast given
        (the map does not change while the graph grows, so one batched fan
        gives the values of per-visit calls); the facelet half runs live,
        since it must see the polyhedra installed earlier in the round."""
        fr = self.frontiers[frontier_idx]
        normal = fr["projected_normal"]
        eps = self.check_frontier_small_distance
        pc = fr["projected_center"] + normal * eps
        # the combined forward check: a map hit wins only below the facelet
        # hit distance
        sp, _, tp, _ = self._facelet_raycast(
            np.asarray(pc, np.float32), normal[None].astype(np.float32),
            self.max_raycast_dist * 2)
        use_map = (not bool(sp[0])) or (map_succ and map_t < float(tp[0]))
        succ = map_succ if use_map else bool(sp[0])
        length = map_t if use_map else float(tp[0])
        if succ and length < self.frontier_verify_threshold:
            fr["is_valid"] = False
            return False
        pc2 = fr["projected_center"] - normal * eps
        s2, _, l2, _ = self._facelet_raycast(
            pc2, normal[None], self.frontier_verify_threshold,
            backward_dist=self.frontier_backward_check,
            skip_idx=fr["master_idx"])
        s2, l2 = bool(s2[0]), float(l2[0])
        if s2 and l2 < self.frontier_verify_threshold:
            fr["is_valid"] = False
            return False
        if (not succ) or (s2 and l2 < length):
            length = l2
        fr["is_valid"] = True
        fr["next_node_initial"] = fr["projected_center"] + \
            fr["projected_normal"] * length / 2
        return True

    def generate_topo_graph(self, start_pt, max_nodes=100, show=False):
        """Expand from ``start_pt`` and visit frontiers in order until
        ``max_nodes`` frontiers were visited; each round of pending
        frontiers shares one map raycast. Returns the node count."""
        self.node_expansion(start_pt, show)
        while (self.search_frontiers_idx < self.num_frontiers and
               self.search_frontiers_idx < max_nodes):
            lo = self.search_frontiers_idx
            hi = min(self.num_frontiers, max_nodes)
            frs = self.frontiers[lo:hi]
            eps = self.check_frontier_small_distance
            pcs = np.stack([f["projected_center"] +
                            f["projected_normal"] * eps for f in frs]
                           ).astype(np.float32)
            nrm = np.stack([f["projected_normal"] for f in frs]
                           ).astype(np.float32)
            sm, _, tm = self._map_raycast(pcs, nrm,
                                          self.max_raycast_dist * 2)
            for k in range(hi - lo):
                i = self.search_frontiers_idx
                if self._verify_frontier_cached(i, bool(sm[k]),
                                                float(tm[k])):
                    fr = self.frontiers[i]
                    self.node_expansion(fr["next_node_initial"], show,
                                        last_node_idx=fr["master_idx"])
                self.search_frontiers_idx += 1
        return self.num_nodes

    def node_expansion_benchmark(self, start_pt, show=False, run_num=100):
        """Mean host ms of detect_collisions and of the hull over
        ``run_num`` runs."""
        start_pt = np.asarray(start_pt, np.float32)
        s = time.time()
        for _ in range(run_num):
            self.detect_collisions(start_pt)
        print(f"avg detect_collisions time "
              f"{(time.time()-s)*1000/run_num:.3f}ms")
        s = time.time()
        for _ in range(run_num):
            hull = ConvexHull(self.black_dirs.astype(np.float64))
            verts = hull.points * self.black_lens[:, None] + start_pt
            _ = verts[hull.simplices]
        print(f"avg gen convex cost time {(time.time()-s)*1000/run_num:.3f}ms")
