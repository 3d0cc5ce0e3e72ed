// ESDF relaxation sweeps (Hopper, sm_90a).
//
// K2 replaces taichislam_tpu/ops/pallas/esdf_sweep.py::esdf_sweep_pallas
// (`_kernel`, `_sweep_math`): one Jacobi sweep over the halo-assembled
// sweep layout, rows of (W, W*W) f32 = [j | i*W + k], W = V + 2.
// K3 replaces esdf_sweep_loop_pallas (`_loop_kernel`): the whole sweep loop
// with in-place halo-shell exchange, slab activity gates and a convergence
// exit. Both run the same row body, `sweep_row`.
//
// What bounds it on the H100: per row the sweep reads and writes W^3 f32 of
// field; a row that updates also reads W^3 f32 of encoded TSDF, and a row of
// an active slab V^3 int8 of side (interior-only). At the main path's 264
// rows that is ~17 MB, 5 us at the HBM rate, one CTA per row in a single
// wave (two CTAs per SM). Every CTA loads, computes and stores at
// the same time as the others, so what is not overlapped inside a CTA adds
// up: the row's loads, then instruction issue over shared memory (the
// stencil's 26 neighbours per updating voxel, the axis scans' dependent
// steps). On the host, a call's Python and launch work is of the same order
// as the kernel (see ops/kernels/esdf_sweep.py).
//
// Design of the row body (one CTA of 256 threads per row):
// - The main path's V = 16 and the examples' V = 8 are compiled with
//   constant shapes (`VC`), so the line and column loops unroll and the
//   scans keep their lines in registers; any other V runs the same code
//   with runtime shapes (its line arrays then sit in local memory).
// - Each warp owns a run of planes (j): it loads their field and enc into
//   registers, 16 bytes a load and four loads of each in flight per lane
//   (K2 also passes the field straight to the output), stages the field,
//   and turns the pair into a flag byte per voxel (fixed, positive /
//   negative source, observed, sign) and an interleaved (lo, -hi) pair per
//   voxel: lo = psrc ? h : BIG and the negated hi, -hi = nsrc ? -h : BIG, so
//   the negative side runs the same min-plus code and is negated back
//   (max(a, b) = -min(-a, -b) and round-to-nearest is symmetric, so this is
//   exact). It then scans its own planes' k and i lines, with no barrier
//   but the warp's own, while the other warps' loads are still landing.
// - The segmented min-plus axis scans: one lane per line and sign, the
//   line's W pairs in registers, forward and backward in one pass; the k
//   candidates are stored, the i candidates taken by min into them. Each
//   candidate is formed by the same rounded steps as the Pallas kernel's
//   Hillis-Steele doubling: x - p*v1, min, + p*v1, + v1 (built with
//   --fmad=false, so nothing contracts into an FMA). The j line is the
//   stencil column's own: its backward candidates are taken by min into
//   the scan arrays before the walk (held in registers, they made K3
//   spill), its forward ones are formed during the walk.
// - Stencil by column walk: each thread owns an interior (i, k) column and
//   walks j. For each plane it reduces the 3x3 neighbourhood once to
//   (centre, min of the 4 in-plane faces, min of the 4 in-plane diagonals)
//   for both signs; a voxel's faces / edges / corners are then mins over
//   its own and the two adjacent planes' partials: 9 pair reads per voxel
//   instead of 26, and no branch inside the 27-loop. Min and max are
//   exact, so any order equals the TPU's separable shifts.
// - Shared memory per row: h, the pairs, the two scan-candidate arrays
//   (pitch V + 1 per line, so no bank conflicts) and the flags, 108 KB at
//   V = 16: two CTAs per SM.
// - Only interior voxels are updated; halo positions pass through (the
//   side mask is interior-only by contract). Only the voxels that update
//   are written by the walk (after the barrier that follows K2's
//   pass-through stores); inactive slabs (K2) copy their rows with 16-byte
//   loads.
// - K3 is one persistent cooperative launch, as the TPU kernel is one call
//   with a real early exit. One SM cannot hold the field resident as the
//   TPU's VMEM did, so the field stays in device memory (L2-resident at the
//   main path's sizes) and the grid runs every sweep itself: shell i, j, k
//   passes, the row compute and the gate update, a grid barrier after each.
//   It leaves the loop after the first sweep that changes nothing, so no
//   launch runs as a no-op. The grid is the rows or, if fewer, the CTAs
//   that fit on the card at once (2 per SM at V = 16); CTAs take rows and
//   slabs by grid stride. The slab gates are derived in sparse form from
//   the 27-neighbour table (one CTA per slab), equal to the TPU's dense
//   adjacency products without their O(n_slab^2) tables. K3 calls the row
//   body in place: the row is staged into shared memory before any of its
//   voxels is written.
// - V above kMaxV (a row no longer fits in a CTA's shared memory) up to
//   kMaxClusterV runs a row per thread-block cluster of C = cluster_ctas(V)
//   CTAs (2 at V = 24, 4 at V = 32, at most a portable 8), the row held in
//   the cluster's shared memory (`sweep_row_cl`). CTA r owns a run of
//   P = ceil(V / C) interior planes and stages the plane on each side of
//   it too, so every stencil read is local; the staged flags carry each
//   voxel's update side, so one scan-candidate array (the side's) serves
//   both signs. The k and i line scans lie inside a plane and stay local,
//   one thread per line with the line in registers. Only the j lines cross
//   CTAs: each CTA reduces its segment of every column to a carry (per
//   sign and direction the min since the segment's last restart, at the
//   global positions, and whether it restarts), publishes it in its shared
//   memory, and after a cluster barrier reads the carries of the ranks
//   before it (forward) and after it (backward) through distributed shared
//   memory and folds them in rank order. min is exact, and every candidate
//   keeps the rounded steps above, so the row equals the one-CTA builds'
//   bit for bit. That barrier also separates every CTA's loads from any
//   CTA's first write (K3 works in place, and a CTA's outer planes are its
//   neighbours' own). K2 launches one cluster per row; K3 one cooperative
//   launch with a cluster dimension, clusters taking rows by grid stride,
//   as many clusters as fit on the card at once. V = 24 and 32 are
//   compiled with constant shapes, any other V up to kMaxClusterV with
//   runtime shapes.
// - Past kMaxClusterV a third build of the one-CTA body, VC = kGlobalV,
//   keeps the row's scratch (the same five arrays) in a slice per CTA of a
//   workspace in device memory that the wrapper allocates; its k and i line
//   scans read and write that scratch, and the update side is read per
//   voxel. Its CTAs take rows by grid stride, so the workspace is one slice
//   per resident CTA. The arithmetic is sweep_row's, step for step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kBig = 1e9f;
constexpr float kEncBig = 1e6f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;  // CTAs per SM the registers are budgeted for
// the largest V whose row fits in the 227 KB of shared memory a CTA may
// take (see smem_bytes); the side bits of a column fit in 32 bits up to 30
constexpr int kMaxV = 20;
constexpr size_t kMaxSmem = 227 * 1024;
// the V compiled with constant shapes: the main path's, and the block size
// of the examples and tests
constexpr int kFastV = 16, kSmallV = 8;
// the VC of the build whose row scratch lives in device memory
// (V > kMaxClusterV)
constexpr int kGlobalV = -1;
// the cluster builds (kMaxV < V <= kMaxClusterV): one CTA per SM, so 512
// threads at 128 registers each, as two CTAs of the one-CTA builds; a
// portable cluster holds at most 8 CTAs
constexpr int kClThreads = 512;
constexpr int kMaxCluster = 8;
constexpr int kMaxClusterV = 40;
// the V whose cluster builds are compiled with constant shapes
constexpr int kClusterV24 = 24, kClusterV32 = 32;
constexpr int kLoads = 4;      // float4 chunks a lane has in flight at once

// flag bits per voxel
constexpr uint8_t kFixed = 1, kPsrc = 2, kNsrc = 4, kObs = 8, kNonNeg = 16;
// the cluster builds' update side, staged with the flags
constexpr uint8_t kSideP = 32, kSideN = 64;

struct Params {
  int V;
  float v1, v2, v3, gamma, eps, max_ray;
};

__host__ __device__ constexpr size_t align16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

// floats of one scan-candidate array: V lines of pitch V + 1 per plane, and
// 16 more, so the two arrays' lines fall on different banks
__host__ __device__ constexpr size_t scan_floats(int V) {
  return (size_t)V * V * (V + 1) + 16;
}

// h | (lo, -hi) pairs | scan_lo, scan_hi | flags
__host__ __device__ constexpr size_t smem_bytes(int V) {
  const size_t W = V + 2, W3 = W * W * W;
  return align16(W3 * 4) + align16(W3 * 8) + align16(2 * scan_floats(V) * 4) +
         W3;
}
static_assert(smem_bytes(kMaxV) <= kMaxSmem &&
                  smem_bytes(kMaxV + 1) > kMaxSmem,
              "kMaxV must be the largest V whose row fits in shared memory");

// one CTA's slice of the device-memory scratch of the kGlobalV build
__host__ __device__ constexpr size_t scratch_bytes(int V) {
  return align16(smem_bytes(V));
}

// the interior planes a CTA of a C-CTA cluster owns (the last may own fewer)
__host__ __device__ constexpr int cl_planes(int V, int C) {
  return (V + C - 1) / C;
}

// one CTA's shared memory in a C-CTA cluster: the pairs of its P owned
// planes and the two beside them, their field, the owned planes' scan
// candidates (pitch V + 1), the column carries and their restart bits, and
// the flags of the P + 2 planes
__host__ __device__ constexpr size_t cl_smem_bytes(int V, int C) {
  const size_t W = V + 2, W2 = W * W, P = cl_planes(V, C);
  const size_t VV = (size_t)V * V;
  return align16((P + 2) * W2 * 8) + align16(P * W2 * 4) +
         align16(P * V * (V + 1) * 4) + VV * 16 + align16(VV) +
         (P + 2) * W2;
}

// the CTAs of a row's cluster: the fewest, from 2, whose share of the row
// fits in a CTA's shared memory; 0 past a portable cluster
__host__ __device__ constexpr int cluster_ctas(int V) {
  for (int C = 2; C <= kMaxCluster; ++C)
    if (cl_smem_bytes(V, C) <= kMaxSmem) return C;
  return 0;
}

// every V of the cluster builds gets a cluster in which every CTA owns a
// plane, and kMaxClusterV is the largest such V
__host__ __device__ constexpr bool cluster_rule_holds() {
  for (int V = kMaxV + 1; V <= kMaxClusterV; ++V) {
    const int C = cluster_ctas(V);
    if (C == 0 || (C - 1) * cl_planes(V, C) >= V) return false;
  }
  return cluster_ctas(kMaxClusterV + 1) == 0;
}
static_assert(cluster_rule_holds(),
              "kMaxClusterV must be the largest V a cluster's rows fit");
static_assert(kClusterV24 % cluster_ctas(kClusterV24) == 0 &&
                  kClusterV32 % cluster_ctas(kClusterV32) == 0,
              "the constant-shape cluster builds split their rows evenly");

struct Row {
  float* h;        // the field row (W^3)
  float2* lh;      // (lo, -hi) of every voxel
  float* scan_lo;  // scan candidates over lo, interior, pitch V + 1
  float* scan_hi;  // scan candidates over -hi
  uint8_t* fl;     // flag bits (W^3)
};

// The row's arrays laid out from `base` (16-byte aligned).
__device__ inline Row carve_at(unsigned char* base, int V) {
  const size_t W = V + 2, W3 = W * W * W;
  const size_t o_lh = align16(W3 * 4), o_s = o_lh + align16(W3 * 8);
  Row r;
  r.h = reinterpret_cast<float*>(base);
  r.lh = reinterpret_cast<float2*>(base + o_lh);
  r.scan_lo = reinterpret_cast<float*>(base + o_s);
  r.scan_hi = r.scan_lo + scan_floats(V);
  r.fl = base + o_s + align16(2 * scan_floats(V) * 4);
  return r;
}

__device__ inline Row carve(int V) {
  extern __shared__ __align__(16) unsigned char smem[];
  return carve_at(smem, V);
}

// The row's arrays of build VC: in shared memory, or for kGlobalV in this
// CTA's slice of the device-memory scratch.
template <int VC>
__device__ inline Row row_arrays(int V, unsigned char* scratch) {
  if constexpr (VC == kGlobalV)
    return carve_at(scratch, V);
  else
    return carve(V);
}

__device__ void copy_row(float* dst, const float* src, int n) {
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0 && (n & 3) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d4[i] = s4[i];
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// K2's update side of the column at (i, k) = base: bit j of pos / neg
__device__ inline void side_bits(const int8_t* side, int base, int W2, int V,
                                 uint32_t& pos, uint32_t& neg) {
  pos = neg = 0;
#pragma unroll 4
  for (int j = 1; j <= V; ++j) {
    const int8_t s = side[j * W2 + base];
    pos |= (uint32_t)(s > 0) << j;
    neg |= (uint32_t)(s < 0) << j;
  }
}

// The flag bits of one voxel from its enc value, and its (lo, -hi) pair.
__device__ inline uint32_t prepare(float e, float hv, float gamma,
                                   float2& lh) {
  const bool obs = e < kEncBig * 0.5f;
  const float t = obs ? e : 0.0f;
  const bool fixed = obs && fabsf(t) < gamma;
  const bool psrc = t >= gamma ? obs : fixed;
  const bool nsrc = t <= -gamma ? obs : fixed;
  lh = make_float2(psrc ? hv : kBig, nsrc ? -hv : kBig);
  return (fixed ? kFixed : 0) | (psrc ? kPsrc : 0) | (nsrc ? kNsrc : 0) |
         (obs ? kObs : 0) | (t >= 0.0f ? kNonNeg : 0);
}

// The staged field, flags and pairs of four voxels, float4 chunk c.
__device__ inline void prepare4(const Row& r, int c, float4 hv, float4 e,
                                float gamma) {
  float2 a, b, x, y;
  const uint32_t f = prepare(e.x, hv.x, gamma, a) |
                     prepare(e.y, hv.y, gamma, b) << 8 |
                     prepare(e.z, hv.z, gamma, x) << 16 |
                     prepare(e.w, hv.w, gamma, y) << 24;
  reinterpret_cast<float4*>(r.h)[c] = hv;
  reinterpret_cast<uint32_t*>(r.fl)[c] = f;
  float4* lh4 = reinterpret_cast<float4*>(r.lh) + 2 * c;
  lh4[0] = make_float4(a.x, a.y, b.x, b.y);
  lh4[1] = make_float4(x.x, x.y, y.x, y.y);
}

// The staged field, flags and pairs of voxels [v0, v1) of the row, lane t
// of nt taking every nt-th float4 chunk (`vec`: v0, v1 and the pointers
// allow it) or voxel. A lane issues kLoads chunks' loads before it uses the
// first. With `pass` (K2) the field also goes to the output.
__device__ inline void prepare_range(const Row& r, const float* h,
                                     const float* enc, float* pass, int v0,
                                     int v1, int t, int nt, bool vec,
                                     float gamma) {
  if (!vec) {
    for (int v = v0 + t; v < v1; v += nt) {
      const float hv = h[v];
      r.h[v] = hv;
      r.fl[v] = prepare(enc[v], hv, gamma, r.lh[v]);
      if (pass) pass[v] = hv;
    }
    return;
  }
  const float4* h4 = reinterpret_cast<const float4*>(h);
  const float4* e4 = reinterpret_cast<const float4*>(enc);
  for (int c0 = v0 / 4 + t; c0 < v1 / 4; c0 += kLoads * nt) {
    float4 hv[kLoads], ev[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int c = c0 + k * nt;
      if (c < v1 / 4) {
        hv[k] = h4[c];
        ev[k] = e4[c];
      }
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int c = c0 + k * nt;
      if (c < v1 / 4) {
        if (pass) reinterpret_cast<float4*>(pass)[c] = hv[k];
        prepare4(r, c, hv[k], ev[k], gamma);
      }
    }
  }
}

// The segmented min-plus scans of one line and one sign, in registers:
// x[q] and f[q] are position q = 0..W-1 of the line (lo or -hi, and its
// flags; `src` the sign's source bit). c[p - 1] gets the lesser of the two
// directions' candidates at interior position p = 1..V. Each is formed by
// the Pallas kernel's rounded steps: forward from positions up to p - 1,
// x - q*v1, min, + q*v1, + v1; backward from positions from p + 1 on,
// x + q*v1, min, - q*v1, + v1. A fixed voxel, a non-source and the line's
// end restart the min.
__device__ __forceinline__ void line_scan(const float* x, const uint8_t* f,
                                          uint8_t src, int V, float v1,
                                          float* c) {
  const int W = V + 2;
  float m = kBig;
#pragma unroll
  for (int q = 0; q < W - 2; ++q) {
    const float pv = __fmul_rn((float)q, v1);
    const float y = __fsub_rn(x[q], pv);
    m = (q == 0 || (f[q] & kFixed) || !(f[q] & src)) ? y : fminf(m, y);
    c[q] = __fadd_rn(__fadd_rn(m, pv), v1);
  }
#pragma unroll
  for (int q = W - 1; q >= 2; --q) {
    const float pv = __fmul_rn((float)q, v1);
    const float y = __fadd_rn(x[q], pv);
    m = (q == W - 1 || (f[q] & kFixed) || !(f[q] & src)) ? y : fminf(m, y);
    c[q - 2] = fminf(c[q - 2], __fadd_rn(__fsub_rn(m, pv), v1));
  }
}

// line_scan for the kGlobalV build: the same steps, position q of the
// line read at scratch index base + q * stride and candidate p - 1 kept at
// o[(p - 1) * ostride] (stored when `first`, else taken by min), with no
// line arrays. min is exact, so taking each direction's candidate by min
// into o equals taking their min first.
__device__ void line_scan_gm(const float* comp, const uint8_t* fl, int base,
                             int stride, int sg, int V, float v1, float* o,
                             int ostride, bool first) {
  const int W = V + 2;
  const uint8_t src = sg ? kNsrc : kPsrc;
  float m = kBig;
  for (int q = 0; q < W - 2; ++q) {
    const int a = base + q * stride;
    const uint8_t f = fl[a];
    const float pv = __fmul_rn((float)q, v1);
    const float y = __fsub_rn(comp[2 * a + sg], pv);
    m = (q == 0 || (f & kFixed) || !(f & src)) ? y : fminf(m, y);
    const float c = __fadd_rn(__fadd_rn(m, pv), v1);
    o[q * ostride] = first ? c : fminf(o[q * ostride], c);
  }
  for (int q = W - 1; q >= 2; --q) {
    const int a = base + q * stride;
    const uint8_t f = fl[a];
    const float pv = __fmul_rn((float)q, v1);
    const float y = __fadd_rn(comp[2 * a + sg], pv);
    m = (q == W - 1 || (f & kFixed) || !(f & src)) ? y : fminf(m, y);
    float* c = o + (q - 2) * ostride;
    *c = fminf(*c, __fadd_rn(__fsub_rn(m, pv), v1));
  }
}

// scan_plane for the kGlobalV build (line_scan_gm on the scratch)
__device__ void scan_plane_gm(const Row& r, int j, int lane, int V,
                              float v1) {
  const int W = V + 2, W2 = W * W, SP = V + 1;
  const float* comp = reinterpret_cast<const float*>(r.lh);
  for (int axis = 0; axis < 2; ++axis) {
    __syncwarp();  // the plane's flags, then its k candidates, are complete
    for (int t = lane; t < 2 * V; t += 32) {
      const int sg = t / V, l = t % V + 1;
      float* out = sg ? r.scan_hi : r.scan_lo;
      if (axis == 0)
        line_scan_gm(comp, r.fl, j * W2 + l * W, 1, sg, V, v1,
                     out + ((j - 1) * V + l - 1) * SP, 1, true);
      else
        line_scan_gm(comp, r.fl, j * W2 + l, W, sg, V, v1,
                     out + (j - 1) * V * SP + l - 1, SP, false);
    }
  }
}

// The k and i lines of interior plane j by one warp, lane = sign * V +
// line (a loop over them past 32): the k candidates are stored, the i
// candidates taken by min into them.
template <int VC>
__device__ __forceinline__ void scan_plane(const Row& r, int j, int lane,
                                           int v_rt, float v1) {
  constexpr int VA = VC > 0 ? VC : kMaxV;
  const int V = VC > 0 ? VC : v_rt;
  const int W = V + 2, W2 = W * W, SP = V + 1;
  const float* comp = reinterpret_cast<const float*>(r.lh);
#pragma unroll
  for (int axis = 0; axis < 2; ++axis) {
    __syncwarp();  // the plane's flags, then its k candidates, are complete
    for (int t = lane; t < 2 * V; t += 32) {
      const int sg = t / V, l = t % V + 1;
      const int base = axis == 0 ? j * W2 + l * W : j * W2 + l;
      const int stride = axis == 0 ? 1 : W;
      float x[VA + 2], c[VA];
      uint8_t f[VA + 2];
#pragma unroll
      for (int q = 0; q < W; ++q) {
        x[q] = comp[2 * (base + q * stride) + sg];
        f[q] = r.fl[base + q * stride];
      }
      line_scan(x, f, sg ? kNsrc : kPsrc, V, v1, c);
      float* out = sg ? r.scan_hi : r.scan_lo;
      if (axis == 0) {
        float* o = out + ((j - 1) * V + l - 1) * SP;
#pragma unroll
        for (int p = 0; p < V; ++p) o[p] = c[p];
      } else {
        float* o = out + (j - 1) * V * SP + l - 1;
#pragma unroll
        for (int p = 0; p < V; ++p) o[p * SP] = fminf(o[p * SP], c[p]);
      }
    }
  }
}

// One plane's 3x3 neighbourhood of (i, k) reduced for one sign: the centre,
// the min of the 4 in-plane faces and the min of the 4 in-plane diagonals.
struct Part {
  float c, f, d;
};

__device__ inline void plane_part(const float2* lh, int idx, int W,
                                  Part& lo, Part& hi) {
  float l[9], n[9];
  const int off[9] = {0, -W, W, -1, 1, -W - 1, -W + 1, W - 1, W + 1};
#pragma unroll
  for (int a = 0; a < 9; ++a) {
    const float2 x = lh[idx + off[a]];
    l[a] = x.x;
    n[a] = x.y;
  }
  lo.c = l[0];
  lo.f = fminf(fminf(l[1], l[2]), fminf(l[3], l[4]));
  lo.d = fminf(fminf(l[5], l[6]), fminf(l[7], l[8]));
  hi.c = n[0];
  hi.f = fminf(fminf(n[1], n[2]), fminf(n[3], n[4]));
  hi.d = fminf(fminf(n[5], n[6]), fminf(n[7], n[8]));
}

// One sweep of one row, V = VC (or p.V when VC is 0 or kGlobalV). `side`
// (K2) gives the update side of each voxel; when it is null (K3) the side
// derives from the flags and `upd`. With `fresh_out` (K2) the whole row is
// first passed to `out` (halo and idle voxels pass through); without it
// (K3, in place: out == h) only the voxels that update are written.
// Returns (to thread 0's caller through *changed) whether any voxel moved
// by more than eps_conv. The kGlobalV build keeps the row in `scratch`, the
// others in shared memory.
template <int VC>
__device__ void sweep_row(const float* h, const float* enc,
                          const int8_t* side, bool upd, float* out,
                          bool fresh_out, const Params& p, bool with_scans,
                          float eps_conv, int* changed,
                          unsigned char* scratch) {
  const int V = VC > 0 ? VC : p.V;
  const int W = V + 2, W2 = W * W, W3 = W2 * W, VV = V * V;
  const int SP = V + 1;  // scan-candidate line pitch
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Row r = row_arrays<VC>(V, scratch);
  float* pass = fresh_out ? out : nullptr;

  uint32_t pos = 0, neg = 0;  // the first column's side, while loads fly
  if constexpr (VC != kGlobalV) {
    if (side && tid < VV)
      side_bits(side, (tid / V + 1) * W + tid % V + 1, W2, V, pos, neg);
  }

  // this warp's planes: an even share of the interior ones, the first warp
  // also plane 0 and the last plane W - 1
  const int j0 = warp == 0 ? 0 : 1 + warp * V / kWarps;
  const int j1 = warp == kWarps - 1 ? W : 1 + (warp + 1) * V / kWarps;
  const bool vec =
      W2 % 4 == 0 &&
      (((uintptr_t)h | (uintptr_t)enc | (uintptr_t)pass) & 15) == 0;
  prepare_range(r, h, enc, pass, j0 * W2, j1 * W2, lane, 32, vec, p.gamma);
  if (with_scans) {
    for (int j = j0 > 1 ? j0 : 1; j < j1 && j <= V; ++j) {
      if constexpr (VC == kGlobalV)
        scan_plane_gm(r, j, lane, V, p.v1);
      else
        scan_plane<VC>(r, j, lane, V, p.v1);
    }
  }
  __syncthreads();  // every plane staged and scanned

  bool moved = false;
  for (int col = tid; col < VV; col += kThreads) {
    const int i = col / V + 1, k = col % V + 1, cb = i * W + k;
    const int sb = (i - 1) * SP + k - 1;  // scan index of (j = 1, i, k)
    if constexpr (VC != kGlobalV) {
      if (side && col != tid) side_bits(side, cb, W2, V, pos, neg);
    }
    // j line: this column's own, so no barrier. Its backward candidates
    // are taken by min into the scan arrays first (in registers they would
    // spill in K3), its forward ones (ml, mh) during the walk.
    if (with_scans) {
      float ml = kBig, mh = kBig;
#pragma unroll
      for (int q = W - 1; q >= 2; --q) {
        const int idx = q * W2 + cb;
        const float2 x = r.lh[idx];
        const uint8_t f = r.fl[idx];
        const bool brk = q == W - 1 || (f & kFixed);
        const float pv = __fmul_rn((float)q, p.v1);
        const float yl = __fadd_rn(x.x, pv), yh = __fadd_rn(x.y, pv);
        ml = (brk || !(f & kPsrc)) ? yl : fminf(ml, yl);
        mh = (brk || !(f & kNsrc)) ? yh : fminf(mh, yh);
        const int o = sb + (q - 2) * V * SP;
        r.scan_lo[o] =
            fminf(r.scan_lo[o], __fadd_rn(__fsub_rn(ml, pv), p.v1));
        r.scan_hi[o] =
            fminf(r.scan_hi[o], __fadd_rn(__fsub_rn(mh, pv), p.v1));
      }
    }
    float ml = kBig, mh = kBig, jl = kBig, jh = kBig;
    Part lo0, hi0, lo1, hi1, lo2, hi2;
    plane_part(r.lh, cb, W, lo0, hi0);
    plane_part(r.lh, W2 + cb, W, lo1, hi1);
#pragma unroll
    for (int j = 1; j <= V; ++j) {
      plane_part(r.lh, (j + 1) * W2 + cb, W, lo2, hi2);
      const int idx = j * W2 + cb;
      if (with_scans) {  // position j - 1 of the j line: plane 0's centre
        const uint8_t f = r.fl[idx - W2];
        const bool brk = j == 1 || (f & kFixed);
        const float pv = __fmul_rn((float)(j - 1), p.v1);
        const float yl = __fsub_rn(lo0.c, pv), yh = __fsub_rn(hi0.c, pv);
        ml = (brk || !(f & kPsrc)) ? yl : fminf(ml, yl);
        mh = (brk || !(f & kNsrc)) ? yh : fminf(mh, yh);
        jl = __fadd_rn(__fadd_rn(ml, pv), p.v1);
        jh = __fadd_rn(__fadd_rn(mh, pv), p.v1);
      }
      int s;
      if (side && VC == kGlobalV) {
        const int8_t sv = side[idx];
        s = sv > 0 ? 1 : (sv < 0 ? -1 : 0);
      } else if (side) {
        s = (pos >> j & 1) ? 1 : ((neg >> j & 1) ? -1 : 0);
      } else {
        const uint8_t f = r.fl[idx];
        s = (upd && (f & kObs) && !(f & kFixed)) ? ((f & kNonNeg) ? 1 : -1)
                                                : 0;
      }
      if (s != 0) {
        // the positive side on lo, the negative on -hi, then negated back
        const Part& a0 = s > 0 ? lo0 : hi0;
        const Part& a1 = s > 0 ? lo1 : hi1;
        const Part& a2 = s > 0 ? lo2 : hi2;
        const float faces = fminf(fminf(a1.f, a0.c), a2.c);
        const float edges = fminf(fminf(a1.d, a0.f), a2.f);
        const float corners = fminf(a0.d, a2.d);
        float cand = fminf(fminf(__fadd_rn(faces, p.v1),
                                 __fadd_rn(edges, p.v2)),
                           __fadd_rn(corners, p.v3));
        if (with_scans) {
          const int o = sb + (j - 1) * V * SP;
          cand = fminf(cand, s > 0 ? fminf(r.scan_lo[o], jl)
                                   : fminf(r.scan_hi[o], jh));
        }
        const float hv = r.h[idx];
        const float sg = s > 0 ? 1.0f : -1.0f;
        const float hn = sg * hv;
        const float nv =
            sg * (cand <= __fadd_rn(hn, p.eps) ? fminf(hn, cand)
                                               : fminf(p.max_ray, cand));
        if (fabsf(__fsub_rn(nv, hv)) > eps_conv) moved = true;
        out[idx] = nv;
      }
      lo0 = lo1;
      hi0 = hi1;
      lo1 = lo2;
      hi1 = hi2;
    }
  }
  // also the barrier that lets the next row (K3) reuse shared memory
  const int any = __syncthreads_or(moved);
  if (changed && tid == 0) *changed = any;
}

template <int VC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    k2_kernel(const float* esdf, const float* enc, const int8_t* side,
              const int32_t* slab_act, float* out, Params p,
              int with_scans) {
  const int W = p.V + 2, W3 = W * W * W;
  const int g = blockIdx.x;
  const size_t off = (size_t)g * W3;
  if (slab_act && slab_act[g / 8] == 0) {
    copy_row(out + off, esdf + off, W3);
    return;
  }
  sweep_row<VC>(esdf + off, enc + off, side + off, false, out + off, true, p,
                with_scans != 0, 0.0f, nullptr, nullptr);
}

// K2 for V > kMaxClusterV: CTAs take rows by grid stride, each CTA working in its
// own slice of `scratch` (scratch_bytes(V) each).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    k2_kernel_gm(const float* esdf, const float* enc, const int8_t* side,
                 const int32_t* slab_act, float* out, Params p,
                 int with_scans, int n_rows, unsigned char* scratch) {
  const int W = p.V + 2, W3 = W * W * W;
  unsigned char* mine = scratch + (size_t)blockIdx.x * scratch_bytes(p.V);
  for (int g = blockIdx.x; g < n_rows; g += gridDim.x) {
    const size_t off = (size_t)g * W3;
    if (slab_act && slab_act[g / 8] == 0) {
      copy_row(out + off, esdf + off, W3);
      continue;
    }
    sweep_row<kGlobalV>(esdf + off, enc + off, side + off, false, out + off,
                        true, p, with_scans != 0, 0.0f, nullptr, mine);
  }
}

// ---- V > kMaxV: one row per thread-block cluster ---------------------------

// A CTA's arrays in its cluster's share of the row (see cl_smem_bytes).
// Local plane l of lh / fl is plane ja - 1 + l of the row; of h and sc,
// owned plane ja + l.
struct ClRow {
  float2* lh;     // (lo, -hi) of planes ja - 1 .. jb
  float* h;       // the field of the owned planes ja .. jb - 1
  float* sc;      // k and i scan candidates of the owned interior voxels,
                  // on each voxel's update side, pitch V + 1
  float4* car;    // per interior column: the j-line carries, forward (lo,
                  // -hi) for the ranks after, backward for those before
  uint8_t* cbrk;  // their restart bits: 1, 2 forward, 4, 8 backward
  uint8_t* fl;    // flag bits with the update side, planes ja - 1 .. jb
};

__device__ inline ClRow carve_cl(int V, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t W = V + 2, W2 = W * W, P = cl_planes(V, C);
  const size_t VV = (size_t)V * V;
  ClRow r;
  size_t o = 0;
  r.lh = reinterpret_cast<float2*>(smem + o);
  o += align16((P + 2) * W2 * 8);
  r.h = reinterpret_cast<float*>(smem + o);
  o += align16(P * W2 * 4);
  r.sc = reinterpret_cast<float*>(smem + o);
  o += align16(P * V * (V + 1) * 4);
  r.car = reinterpret_cast<float4*>(smem + o);
  o += VV * 16;
  r.cbrk = smem + o;
  r.fl = smem + o + align16(VV);
  return r;
}

// This CTA's place in its row's cluster: rank r of C owns interior planes
// [ja, jb), and writes K2's pass-through of planes [pa, pb) (its own, and
// plane 0 / W - 1 at the ends).
struct Own {
  int C, rank, P, ja, jb, pa, pb;
};

template <int VC>
__device__ inline Own own_planes(int V) {
  cg::cluster_group cl = cg::this_cluster();
  Own o;
  o.C = VC > 0 ? cluster_ctas(VC) : (int)cl.num_blocks();
  o.rank = (int)cl.block_rank();
  o.P = cl_planes(V, o.C);
  o.ja = 1 + o.rank * o.P;
  o.jb = min(V + 1, o.ja + o.P);
  o.pa = o.rank == 0 ? 0 : o.ja;
  o.pb = o.rank == o.C - 1 ? V + 2 : o.jb;
  return o;
}

// The flag bits of a voxel with its update side: K2's from `s` (given),
// K3's derived as the loop derives it (observed and not fixed, on the
// sign's side; the row is updatable).
__device__ inline uint32_t with_side(uint32_t f, int s, bool given) {
  if (!given)
    s = ((f & kObs) && !(f & kFixed)) ? ((f & kNonNeg) ? 1 : -1) : 0;
  return f | (s > 0 ? kSideP : 0) | (s < 0 ? kSideN : 0);
}

// Stages voxels [v0, v1) of the row (planes ja - 1 .. jb) at local index
// v - v0: flags with the update side, pairs, and the field of the owned
// voxels [v0 + W2, v1 - W2); with `pass` (K2) the field of [pa, pb) also
// goes to the output. Lanes take float4 chunks (`vec`), kLoads in flight,
// or voxels.
__device__ void prepare_cl(const ClRow& r, const float* h, const float* enc,
                           const int8_t* side, float* pass, int v0, int v1,
                           int W2, int pa, int pb, bool vec, float gamma) {
  const int t = threadIdx.x, nt = blockDim.x;
  const bool given = side != nullptr;
  if (!vec) {
    for (int v = v0 + t; v < v1; v += nt) {
      const float hv = h[v];
      const int l = v - v0;
      r.fl[l] = with_side(prepare(enc[v], hv, gamma, r.lh[l]),
                          given ? side[v] : 0, given);
      if (l >= W2 && v < v1 - W2) r.h[l - W2] = hv;
      if (pass && v >= pa && v < pb) pass[v] = hv;
    }
    return;
  }
  const float4* h4 = reinterpret_cast<const float4*>(h);
  const float4* e4 = reinterpret_cast<const float4*>(enc);
  const uint32_t* s4 = reinterpret_cast<const uint32_t*>(side);
  for (int c0 = v0 / 4 + t; c0 < v1 / 4; c0 += kLoads * nt) {
    float4 hv[kLoads], ev[kLoads];
    uint32_t sv[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int c = c0 + k * nt;
      if (c < v1 / 4) {
        hv[k] = h4[c];
        ev[k] = e4[c];
        sv[k] = given ? s4[c] : 0;
      }
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int c = c0 + k * nt, v = 4 * c, l = v - v0;
      if (c >= v1 / 4) continue;
      if (pass && v >= pa && v < pb)
        reinterpret_cast<float4*>(pass)[c] = hv[k];
      const float4 x = hv[k], e = ev[k];
      const uint32_t s = sv[k];
      float2 a, b, y, z;
      const uint32_t f =
          with_side(prepare(e.x, x.x, gamma, a), (int8_t)(s & 0xff), given) |
          with_side(prepare(e.y, x.y, gamma, b), (int8_t)(s >> 8 & 0xff),
                    given) << 8 |
          with_side(prepare(e.z, x.z, gamma, y), (int8_t)(s >> 16 & 0xff),
                    given) << 16 |
          with_side(prepare(e.w, x.w, gamma, z), (int8_t)(s >> 24), given)
              << 24;
      reinterpret_cast<uint32_t*>(r.fl)[l / 4] = f;
      float4* lh4 = reinterpret_cast<float4*>(r.lh) + 2 * (l / 4);
      lh4[0] = make_float4(a.x, a.y, b.x, b.y);
      lh4[1] = make_float4(y.x, y.y, z.x, z.y);
      if (l >= W2 && v < v1 - W2)
        reinterpret_cast<float4*>(r.h)[(l - W2) / 4] = x;
    }
  }
}

// line_scan with the line's restarts as bits (bit q: a fixed voxel or a
// non-source at position q; the line's ends restart by position).
__device__ __forceinline__ void line_scan_bits(const float* x, uint64_t brk,
                                               int V, float v1, float* c) {
  const int W = V + 2;
  float m = kBig;
#pragma unroll
  for (int q = 0; q < W - 2; ++q) {
    const float pv = __fmul_rn((float)q, v1);
    const float y = __fsub_rn(x[q], pv);
    m = (q == 0 || (brk >> q & 1)) ? y : fminf(m, y);
    c[q] = __fadd_rn(__fadd_rn(m, pv), v1);
  }
#pragma unroll
  for (int q = W - 1; q >= 2; --q) {
    const float pv = __fmul_rn((float)q, v1);
    const float y = __fadd_rn(x[q], pv);
    m = (q == W - 1 || (brk >> q & 1)) ? y : fminf(m, y);
    c[q - 2] = fminf(c[q - 2], __fadd_rn(__fsub_rn(m, pv), v1));
  }
}

// The k (axis 0) or i (axis 1) lines of the n_own owned planes, a thread
// per (plane, sign, line): the line's pairs in registers, its restarts and
// the voxels on the sign's update side as bits. A candidate goes to its
// voxel only on the voxel's side: the k candidates stored, the i ones taken
// by min into them.
template <int VC>
__device__ void scan_lines_cl(const ClRow& r, int axis, int n_own, int v_rt,
                              float v1) {
  constexpr int VA = VC > 0 ? VC : kMaxClusterV;
  const int V = VC > 0 ? VC : v_rt;
  const int W = V + 2, W2 = W * W, SP = V + 1;
  const float* comp = reinterpret_cast<const float*>(r.lh);
  for (int t = threadIdx.x; t < n_own * 2 * V; t += blockDim.x) {
    const int jl = t / (2 * V), sg = t / V % 2, l = t % V + 1;
    const int base = (jl + 1) * W2 + (axis == 0 ? l * W : l);
    const int stride = axis == 0 ? 1 : W;
    const uint8_t src = sg ? kNsrc : kPsrc, want = sg ? kSideN : kSideP;
    float x[VA + 2], c[VA];
    uint64_t brk = 0, mine = 0;
#pragma unroll
    for (int q = 0; q < W; ++q) {
      const int a = base + q * stride;
      const uint8_t f = r.fl[a];
      x[q] = comp[2 * a + sg];
      brk |= (uint64_t)((f & kFixed) || !(f & src)) << q;
      mine |= (uint64_t)((f & want) != 0) << q;
    }
    line_scan_bits(x, brk, V, v1, c);
    if (axis == 0) {
      float* o = r.sc + (jl * V + l - 1) * SP;
#pragma unroll
      for (int p = 0; p < V; ++p)
        if (mine >> (p + 1) & 1) o[p] = c[p];
    } else {
      float* o = r.sc + jl * V * SP + l - 1;
#pragma unroll
      for (int p = 0; p < V; ++p)
        if (mine >> (p + 1) & 1) o[p * SP] = fminf(o[p * SP], c[p]);
    }
  }
}

// Column cb's j-line segments in this CTA, as carries for the other ranks:
// forward over positions ja - 1 .. jb - 2, backward over jb .. ja + 1; per
// sign the min since the segment's last restart of x - q*v1 (forward) or
// x + q*v1 (backward), q the global position, and whether it restarts.
__device__ inline void column_carry(const ClRow& r, const Own& o, int cb,
                                    int W, float v1, float4& agg,
                                    uint8_t& bits) {
  const int W2 = W * W;
  float fl = kBig, fh = kBig, bl = kBig, bh = kBig;
  uint32_t b = 0;
  for (int q = o.ja - 1; q <= o.jb - 2; ++q) {
    const int idx = (q - o.ja + 1) * W2 + cb;
    const float2 x = r.lh[idx];
    const uint8_t f = r.fl[idx];
    const bool brk = q == 0 || (f & kFixed);
    const float pv = __fmul_rn((float)q, v1);
    const float yl = __fsub_rn(x.x, pv), yh = __fsub_rn(x.y, pv);
    if (brk || !(f & kPsrc)) {
      fl = yl;
      b |= 1;
    } else {
      fl = fminf(fl, yl);
    }
    if (brk || !(f & kNsrc)) {
      fh = yh;
      b |= 2;
    } else {
      fh = fminf(fh, yh);
    }
  }
  for (int q = o.jb; q >= o.ja + 1; --q) {
    const int idx = (q - o.ja + 1) * W2 + cb;
    const float2 x = r.lh[idx];
    const uint8_t f = r.fl[idx];
    const bool brk = q == W - 1 || (f & kFixed);
    const float pv = __fmul_rn((float)q, v1);
    const float yl = __fadd_rn(x.x, pv), yh = __fadd_rn(x.y, pv);
    if (brk || !(f & kPsrc)) {
      bl = yl;
      b |= 4;
    } else {
      bl = fminf(bl, yl);
    }
    if (brk || !(f & kNsrc)) {
      bh = yh;
      b |= 8;
    } else {
      bh = fminf(bh, yh);
    }
  }
  agg = make_float4(fl, fh, bl, bh);
  bits = (uint8_t)b;
}

// One sweep of the owned planes of a row whose cluster holds it, V = VC
// (or p.V when VC is 0). `side` (K2) gives the update side of each voxel;
// when it is null (K3) the side derives from the flags. With `fresh_out`
// (K2) planes [pa, pb) are first passed to `out`; without it (K3, in place:
// out == h) only the voxels that update are written. Returns to every
// thread whether a voxel of this CTA's planes moved by more than eps_conv.
template <int VC>
__device__ bool sweep_row_cl(const float* h, const float* enc,
                             const int8_t* side, float* out, bool fresh_out,
                             const Params& p, bool with_scans,
                             float eps_conv) {
  cg::cluster_group cl = cg::this_cluster();
  const int V = VC > 0 ? VC : p.V;
  const int W = V + 2, W2 = W * W, VV = V * V, SP = V + 1;
  const Own o = own_planes<VC>(V);
  const int n_own = o.jb - o.ja;
  const ClRow r = carve_cl(V, o.C);
  float* pass = fresh_out ? out : nullptr;
  const bool vec =
      W2 % 4 == 0 &&
      (((uintptr_t)h | (uintptr_t)enc | (uintptr_t)pass) & 15) == 0 &&
      ((uintptr_t)side & 3) == 0;
  prepare_cl(r, h, enc, side, pass, (o.ja - 1) * W2, (o.jb + 1) * W2, W2,
             o.pa * W2, o.pb * W2, vec, p.gamma);
  __syncthreads();
  if (with_scans) {
    scan_lines_cl<VC>(r, 0, n_own, V, p.v1);
    __syncthreads();  // every k candidate stored
    scan_lines_cl<VC>(r, 1, n_own, V, p.v1);
    for (int col = threadIdx.x; col < VV; col += blockDim.x)
      column_carry(r, o, (col / V + 1) * W + col % V + 1, W, p.v1,
                   r.car[col], r.cbrk[col]);
  }
  // every CTA's loads are done before any CTA writes (K3 works in place,
  // and a CTA's outer planes are its neighbours' own); the candidates and
  // carries are complete
  cl.sync();

  bool moved = false;
  for (int col = threadIdx.x; col < VV; col += blockDim.x) {
    const int i = col / V + 1, k = col % V + 1, cb = i * W + k;
    const int sb = (i - 1) * SP + k - 1;  // scan index of (ja, i, k)
    float ml = kBig, mh = kBig;  // the forward j scan, from the ranks before
    if (with_scans) {
      float bl = kBig, bh = kBig;  // the backward one, from those after
      for (int q = 0; q < o.rank; ++q) {
        const float4 a = cl.map_shared_rank(r.car, q)[col];
        const uint8_t b = cl.map_shared_rank(r.cbrk, q)[col];
        ml = (b & 1) ? a.x : fminf(ml, a.x);
        mh = (b & 2) ? a.y : fminf(mh, a.y);
      }
      for (int q = o.C - 1; q > o.rank; --q) {
        const float4 a = cl.map_shared_rank(r.car, q)[col];
        const uint8_t b = cl.map_shared_rank(r.cbrk, q)[col];
        bl = (b & 4) ? a.z : fminf(bl, a.z);
        bh = (b & 8) ? a.w : fminf(bh, a.w);
      }
      // the backward candidates of the owned positions, by min into the
      // scan candidates of their side
      for (int q = o.jb; q >= o.ja + 1; --q) {
        const int idx = (q - o.ja + 1) * W2 + cb;
        const float2 x = r.lh[idx];
        const uint8_t f = r.fl[idx], fs = r.fl[idx - W2];
        const bool brk = q == W - 1 || (f & kFixed);
        const float pv = __fmul_rn((float)q, p.v1);
        const float yl = __fadd_rn(x.x, pv), yh = __fadd_rn(x.y, pv);
        bl = (brk || !(f & kPsrc)) ? yl : fminf(bl, yl);
        bh = (brk || !(f & kNsrc)) ? yh : fminf(bh, yh);
        float* s = r.sc + sb + (q - 1 - o.ja) * V * SP;
        if (fs & kSideP)
          *s = fminf(*s, __fadd_rn(__fsub_rn(bl, pv), p.v1));
        else if (fs & kSideN)
          *s = fminf(*s, __fadd_rn(__fsub_rn(bh, pv), p.v1));
      }
    }
    Part lo0, hi0, lo1, hi1, lo2, hi2;
    plane_part(r.lh, cb, W, lo0, hi0);
    plane_part(r.lh, W2 + cb, W, lo1, hi1);
    constexpr int kWalk = VC > 0 ? cl_planes(VC, cluster_ctas(VC)) : 0;
#pragma unroll
    for (int l = 0; l < (kWalk > 0 ? kWalk : n_own); ++l) {
      const int j = o.ja + l;  // local plane l + 1
      plane_part(r.lh, (l + 2) * W2 + cb, W, lo2, hi2);
      float jl = kBig, jh = kBig;
      if (with_scans) {  // position j - 1 of the j line: plane 0's centre
        const uint8_t f = r.fl[l * W2 + cb];
        const bool brk = j == 1 || (f & kFixed);
        const float pv = __fmul_rn((float)(j - 1), p.v1);
        const float yl = __fsub_rn(lo0.c, pv), yh = __fsub_rn(hi0.c, pv);
        ml = (brk || !(f & kPsrc)) ? yl : fminf(ml, yl);
        mh = (brk || !(f & kNsrc)) ? yh : fminf(mh, yh);
        jl = __fadd_rn(__fadd_rn(ml, pv), p.v1);
        jh = __fadd_rn(__fadd_rn(mh, pv), p.v1);
      }
      const uint8_t f = r.fl[(l + 1) * W2 + cb];
      const int s = (f & kSideP) ? 1 : ((f & kSideN) ? -1 : 0);
      if (s != 0) {
        const Part& a0 = s > 0 ? lo0 : hi0;
        const Part& a1 = s > 0 ? lo1 : hi1;
        const Part& a2 = s > 0 ? lo2 : hi2;
        const float faces = fminf(fminf(a1.f, a0.c), a2.c);
        const float edges = fminf(fminf(a1.d, a0.f), a2.f);
        const float corners = fminf(a0.d, a2.d);
        float cand = fminf(fminf(__fadd_rn(faces, p.v1),
                                 __fadd_rn(edges, p.v2)),
                           __fadd_rn(corners, p.v3));
        if (with_scans)
          cand = fminf(cand, fminf(r.sc[sb + l * V * SP], s > 0 ? jl : jh));
        const float hv = r.h[l * W2 + cb];
        const float sg = s > 0 ? 1.0f : -1.0f;
        const float hn = sg * hv;
        const float nv =
            sg * (cand <= __fadd_rn(hn, p.eps) ? fminf(hn, cand)
                                               : fminf(p.max_ray, cand));
        if (fabsf(__fsub_rn(nv, hv)) > eps_conv) moved = true;
        out[j * W2 + cb] = nv;
      }
      lo0 = lo1;
      hi0 = hi1;
      lo1 = lo2;
      hi1 = hi2;
    }
  }
  const bool any = __syncthreads_or(moved);
  cl.sync();  // the carries stay until every CTA of the cluster read them
  return any;
}

// K2 for kMaxV < V <= kMaxClusterV: one cluster per row, grid = rows x C.
template <int VC>
__global__ void __launch_bounds__(kClThreads, 1)
    k2_kernel_cl(const float* esdf, const float* enc, const int8_t* side,
                 const int32_t* slab_act, float* out, Params p,
                 int with_scans) {
  const int V = VC > 0 ? VC : p.V, W = V + 2, W2 = W * W;
  const Own o = own_planes<VC>(V);
  const int g = blockIdx.x / o.C;
  const size_t off = (size_t)g * W2 * W;
  if (slab_act && slab_act[g / 8] == 0) {
    copy_row(out + off + o.pa * W2, esdf + off + o.pa * W2,
             (o.pb - o.pa) * W2);
    return;
  }
  sweep_row_cl<VC>(esdf + off, enc + off, side + off, out + off, true, p,
                   with_scans != 0, 0.0f);
}

// ---- K3: the sweep loop in one cooperative launch --------------------------
// Each CTA takes rows (and slabs) by grid stride inside every phase; a grid
// barrier separates the phases. Gate state in `ws` (int32):
//   acts[n_slab] | shell[2][n_slab] | chg[2][n_slab] | changed[2]
// The shell and chg buffers alternate by sweep parity, so a buffer is zeroed
// for the next sweep while the current one is read.

// halo-shell passes: within a pass, reads touch i (or j, k) in {1, V} of the
// neighbour rows and writes touch {0, V+1} of this row, so rows run in
// parallel exactly
__device__ void shell_i_row(float* fld, const int32_t* nsl, int n_rows, int g,
                            int V) {
  const int W = V + 2, W2 = W * W;
  const size_t W3 = (size_t)W2 * W;
  const float* im = fld + nsl[4 * n_rows + g] * W3;
  const float* ip = fld + nsl[22 * n_rows + g] * W3;
  float* row = fld + g * W3;
  for (int t = threadIdx.x; t < W2; t += blockDim.x) {
    int j = t / W, k = t - j * W;
    row[j * W2 + k] = im[j * W2 + V * W + k];
    row[j * W2 + (V + 1) * W + k] = ip[j * W2 + W + k];
  }
}

__device__ void shell_j_row(float* fld, const int32_t* nsl, int n_rows, int g,
                            int V) {
  const int W = V + 2, W2 = W * W;
  const size_t W3 = (size_t)W2 * W;
  const float* jm = fld + nsl[10 * n_rows + g] * W3;
  const float* jp = fld + nsl[16 * n_rows + g] * W3;
  float* row = fld + g * W3;
  for (int t = threadIdx.x; t < W2; t += blockDim.x) {
    row[t] = jm[V * W2 + t];
    row[(V + 1) * W2 + t] = jp[W2 + t];
  }
}

__device__ void shell_k_row(float* fld, const int32_t* nsl, int n_rows, int g,
                            int V) {
  const int W = V + 2, W2 = W * W;
  const size_t W3 = (size_t)W2 * W;
  const float* km = fld + nsl[12 * n_rows + g] * W3;
  const float* kp = fld + nsl[14 * n_rows + g] * W3;
  float* row = fld + g * W3;
  for (int t = threadIdx.x; t < W2; t += blockDim.x) {
    int base = t * W;  // (j, i) = (t / W, t % W)
    row[base] = km[base + V];
    row[base + V + 1] = kp[base + 1];
  }
}

// Slab gates in sparse form, one CTA per slab m: acts[m] is the OR, over the
// updatable rows of m and their 27 neighbours, of chg[slab(nbr)] (every slab
// counts as changed when chg is null: the initial gates); for an active m,
// every row of m marks the slabs of its 27 neighbours in `shell`.
__device__ void gate_slabs(const int32_t* nsl, const int32_t* upd,
                           const int32_t* chg, int32_t* acts, int32_t* shell,
                           int n_rows, int n_slab) {
  const int t = threadIdx.x;
  const bool lane = t < 8 * 27;
  for (int m = blockIdx.x; m < n_slab; m += gridDim.x) {
    int nbr_slab = 0;
    bool hit = false;
    if (lane) {
      const int g = m * 8 + t / 27, c = t % 27;
      nbr_slab = nsl[c * n_rows + g] / 8;
      hit = upd[g] != 0 && (chg == nullptr || chg[nbr_slab] != 0);
    }
    const int a = __syncthreads_or(hit);
    if (t == 0) acts[m] = a;
    if (a && lane) shell[nbr_slab] = 1;
  }
}

// The sweep loop of K3 around `rows(acts, scans, chg, changed)`, which
// computes this CTA's share of a sweep's rows (those of the active slabs
// `acts`), marks the slabs whose rows changed in `chg` and `*changed`, and
// returns the computed slabs it counts (thread 0).
template <class Rows>
__device__ void sweep_loop(const float* esdf_in, float* fld,
                           const int32_t* nsl, const int32_t* upd, int32_t* ws,
                           int32_t* stats, int n_rows, int V, int max_sweeps,
                           int scan_sweeps, int scan_period, Rows rows) {
  cg::grid_group grid = cg::this_grid();
  const int n_slab = n_rows / 8;
  int32_t* acts = ws;
  int32_t* shell = ws + n_slab;
  int32_t* chg = ws + 3 * n_slab;
  int32_t* changed = ws + 5 * n_slab;
  const int W = V + 2;
  const size_t W3 = (size_t)W * W * W;
  const int64_t gtid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * blockDim.x;

  // prologue: the field into the output, the gate state and stats zeroed
  for (int64_t i = gtid; i < (int64_t)n_rows * (int64_t)W3; i += gstride)
    fld[i] = esdf_in[i];
  for (int64_t i = gtid; i < 5 * n_slab + 2; i += gstride) ws[i] = 0;
  if (gtid < 4) stats[gtid] = 0;
  grid.sync();
  gate_slabs(nsl, upd, nullptr, acts, shell, n_rows, n_slab);
  grid.sync();

  int comp = 0, shells = 0;  // this CTA's counts (thread 0)
  int s = 0;
  bool quiet = false;
  while (s < max_sweeps) {
    const int cur = s & 1, nxt = cur ^ 1;
    int32_t* sh = shell + cur * n_slab;
    for (int64_t i = gtid; i < n_slab; i += gstride) {
      shell[nxt * n_slab + i] = 0;
      chg[nxt * n_slab + i] = 0;
    }
    if (gtid == 0) changed[nxt] = 0;
    for (int g = blockIdx.x; g < n_rows; g += gridDim.x) {
      if (!sh[g / 8]) continue;
      if (threadIdx.x == 0) ++shells;
      shell_i_row(fld, nsl, n_rows, g, V);
    }
    grid.sync();
    for (int g = blockIdx.x; g < n_rows; g += gridDim.x) {
      if (sh[g / 8]) shell_j_row(fld, nsl, n_rows, g, V);
    }
    grid.sync();
    for (int g = blockIdx.x; g < n_rows; g += gridDim.x) {
      if (sh[g / 8]) shell_k_row(fld, nsl, n_rows, g, V);
    }
    grid.sync();
    const bool scans =
        s < scan_sweeps || (scan_period > 0 && s % scan_period == 0);
    comp += rows(acts, scans, chg + cur * n_slab, changed + cur);
    grid.sync();
    ++s;
    if (!changed[cur]) {
      quiet = true;
      break;
    }
    gate_slabs(nsl, upd, chg + cur * n_slab, acts, shell + nxt * n_slab,
               n_rows, n_slab);
    grid.sync();
  }
  if (threadIdx.x == 0) {
    if (comp) atomicAdd(&stats[2], comp);
    if (shells) atomicAdd(&stats[3], shells);
  }
  if (gtid == 0) {
    stats[0] = s;
    stats[1] = quiet ? 0 : 1;
  }
}

template <int VC>
__global__ void __launch_bounds__(kThreads, kMinBlocks) k3_loop_kernel(
    const float* esdf_in, float* fld, const float* enc, const int32_t* nsl,
    const int32_t* upd, int32_t* ws, int32_t* stats, int n_rows, Params p,
    float eps_conv, int max_sweeps, int scan_sweeps, int scan_period,
    unsigned char* scratch) {
  __shared__ int row_changed;
  const int W = p.V + 2;
  const size_t W3 = (size_t)W * W * W;
  sweep_loop(esdf_in, fld, nsl, upd, ws, stats, n_rows, p.V, max_sweeps,
             scan_sweeps, scan_period,
             [&](const int32_t* acts, bool scans, int32_t* chg,
                 int32_t* changed) {
               int comp = 0;
               for (int g = blockIdx.x; g < n_rows; g += gridDim.x) {
                 const int slab = g / 8;
                 if (!acts[slab]) continue;
                 if (threadIdx.x == 0 && g % 8 == 0) ++comp;
                 if (!upd[g]) continue;  // a side of zeros: a pass-through
                 const size_t off = (size_t)g * W3;
                 sweep_row<VC>(
                     fld + off, enc + off, nullptr, true, fld + off, false, p,
                     scans, eps_conv, &row_changed,
                     VC == kGlobalV
                         ? scratch + (size_t)blockIdx.x * scratch_bytes(p.V)
                         : nullptr);
                 if (threadIdx.x == 0 && row_changed) {
                   chg[slab] = 1;
                   *changed = 1;
                 }
                 __syncthreads();  // row_changed is reused by the next row
               }
               return comp;
             });
}

// K3 for kMaxV < V <= kMaxClusterV: one cooperative launch in clusters of
// C CTAs; a cluster takes rows by grid stride, each CTA marking its slab
// changed when its planes moved (together the cluster's OR). Rank 0 counts
// the computed slabs.
template <int VC>
__global__ void __launch_bounds__(kClThreads, 1) k3_loop_kernel_cl(
    const float* esdf_in, float* fld, const float* enc, const int32_t* nsl,
    const int32_t* upd, int32_t* ws, int32_t* stats, int n_rows, Params p,
    float eps_conv, int max_sweeps, int scan_sweeps, int scan_period) {
  const int V = VC > 0 ? VC : p.V, W = V + 2;
  const size_t W3 = (size_t)W * W * W;
  const Own o = own_planes<VC>(V);
  const int cid = blockIdx.x / o.C, n_cl = gridDim.x / o.C;
  sweep_loop(esdf_in, fld, nsl, upd, ws, stats, n_rows, V, max_sweeps,
             scan_sweeps, scan_period,
             [&](const int32_t* acts, bool scans, int32_t* chg,
                 int32_t* changed) {
               int comp = 0;
               for (int g = cid; g < n_rows; g += n_cl) {
                 const int slab = g / 8;
                 if (!acts[slab]) continue;
                 if (threadIdx.x == 0 && o.rank == 0 && g % 8 == 0) ++comp;
                 if (!upd[g]) continue;
                 const size_t off = (size_t)g * W3;
                 const bool moved =
                     sweep_row_cl<VC>(fld + off, enc + off, nullptr,
                                      fld + off, false, p, scans, eps_conv);
                 if (threadIdx.x == 0 && moved) {
                   chg[slab] = 1;
                   *changed = 1;
                 }
               }
               return comp;
             });
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// A launch of `grid` CTAs of kClThreads in clusters of C on `stream`, one
// cooperative grid when `coop`; `attrs` holds its two attributes.
cudaLaunchConfig_t cl_config(int grid, int C, size_t smem, bool coop,
                             void* stream, cudaLaunchAttribute* attrs) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kClThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = C;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = coop ? 2 : 1;
  return cfg;
}

// the cluster builds of K2 and K3 at V
const void* k2_cl(int V) {
  return V == kClusterV24   ? (const void*)k2_kernel_cl<kClusterV24>
         : V == kClusterV32 ? (const void*)k2_kernel_cl<kClusterV32>
                            : (const void*)k2_kernel_cl<0>;
}

const void* k3_cl(int V) {
  return V == kClusterV24   ? (const void*)k3_loop_kernel_cl<kClusterV24>
         : V == kClusterV32 ? (const void*)k3_loop_kernel_cl<kClusterV32>
                            : (const void*)k3_loop_kernel_cl<0>;
}

// Sets a cluster build's shared memory for V and gives the clusters of it
// that fit on the card at once (cooperative when `coop`, as K3 launches).
cudaError_t cl_prepare(const void* kernel, int V, bool coop, int* clusters) {
  const int C = cluster_ctas(V);
  const size_t smem = cl_smem_bytes(V, C);
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t cfg = cl_config(C, C, smem, coop, nullptr, attrs);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

}  // namespace

// The clusters of K2's (`loop` 0) or K3's (`loop` 1) build at V that fit
// on the card at once, into *clusters; 0 where V takes no cluster build.
extern "C" int esdf_max_clusters(int V, int loop, int* clusters) {
  *clusters = 0;
  if (V <= kMaxV || V > kMaxClusterV) return 0;
  return (int)cl_prepare(loop ? k3_cl(V) : k2_cl(V), V, loop != 0, clusters);
}

// One sweep (K2) on `stream`; a null slab_act runs every slab. The
// shared-memory attribute is set once per process and V (the kernel, with
// constant or runtime shapes, follows V). kMaxV < V <= kMaxClusterV runs
// k2_kernel_cl, a cluster of cluster_ctas(V) CTAs per row; a larger V
// k2_kernel_gm on scratch_ctas CTAs (at most n_rows), `scratch` holding
// scratch_bytes(V) for each.
extern "C" int esdf_sweep_launch(const void* esdf, const void* enc,
                                 const void* side, const void* slab_act,
                                 void* out, int n_rows, int V, float v1,
                                 float v2, float v3, float gamma, float eps,
                                 float max_ray, int with_scans, void* scratch,
                                 int scratch_ctas, void* stream) {
  static int cached_V = -1;
  if (V < 1 || n_rows < 1) return (int)cudaErrorInvalidValue;
  Params p{V, v1, v2, v3, gamma, eps, max_ray};
  if (V > kMaxClusterV) {
    if (!scratch || scratch_ctas < 1) return (int)cudaErrorInvalidValue;
    const int grid = n_rows < scratch_ctas ? n_rows : scratch_ctas;
    k2_kernel_gm<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)esdf, (const float*)enc, (const int8_t*)side,
        (const int32_t*)slab_act, (float*)out, p, with_scans, n_rows,
        (unsigned char*)scratch);
    return (int)cudaGetLastError();
  }
  if (V > kMaxV) {
    const int C = cluster_ctas(V);
    const size_t smem = cl_smem_bytes(V, C);
    const void* kernel = k2_cl(V);
    if (cached_V != V) {
      cudaError_t e = set_smem(kernel, smem);
      if (e != cudaSuccess) return (int)e;
      cached_V = V;
    }
    const float* a0 = (const float*)esdf;
    const float* a1 = (const float*)enc;
    const int8_t* a2 = (const int8_t*)side;
    const int32_t* a3 = (const int32_t*)slab_act;
    float* a4 = (float*)out;
    void* args[] = {&a0, &a1, &a2, &a3, &a4, &p, &with_scans};
    cudaLaunchAttribute attrs[2];
    const cudaLaunchConfig_t cfg =
        cl_config(n_rows * C, C, smem, false, stream, attrs);
    const cudaError_t e = cudaLaunchKernelExC(&cfg, kernel, args);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
  }
  const size_t smem = smem_bytes(V);
  const auto kernel = V == kFastV    ? k2_kernel<kFastV>
                      : V == kSmallV ? k2_kernel<kSmallV>
                                     : k2_kernel<0>;
  if (cached_V != V) {
    cudaError_t e = set_smem((const void*)kernel, smem);
    if (e != cudaSuccess) return (int)e;
    cached_V = V;
  }
  kernel<<<n_rows, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)esdf, (const float*)enc, (const int8_t*)side,
      (const int32_t*)slab_act, (float*)out, p, with_scans);
  return (int)cudaGetLastError();
}

// The whole loop in one cooperative launch on `stream`: grid = the rows or,
// if fewer, the CTAs that fit on the card at once. The attribute and the
// occupancy are looked up once per process and V. kMaxV < V <= kMaxClusterV
// runs k3_loop_kernel_cl in clusters of cluster_ctas(V) CTAs, the rows or,
// if fewer, the clusters that fit at once; a larger V
// k3_loop_kernel<kGlobalV> on at most scratch_ctas CTAs, `scratch` holding
// scratch_bytes(V) for each.
extern "C" int esdf_loop_launch(const void* esdf_in, void* fld,
                                const void* enc, const void* nsl27,
                                const void* upd, void* ws, void* stats,
                                int n_rows, int V, float v1, float v2,
                                float v3, float gamma, float eps,
                                float max_ray, float eps_conv, int max_sweeps,
                                int scan_sweeps, int scan_period,
                                void* scratch, int scratch_ctas,
                                void* stream) {
  static int cached_V = -1, cached_ctas = 0;
  if (V < 1) return (int)cudaErrorInvalidValue;
  const bool gm = V > kMaxClusterV, cl = V > kMaxV && !gm;
  if (gm && (!scratch || scratch_ctas < 1)) return (int)cudaErrorInvalidValue;
  const int C = cl ? cluster_ctas(V) : 1;
  const size_t smem = gm ? 0 : cl ? cl_smem_bytes(V, C) : smem_bytes(V);
  const void* kernel = cl            ? k3_cl(V)
                       : gm          ? (const void*)k3_loop_kernel<kGlobalV>
                       : V == kFastV ? (const void*)k3_loop_kernel<kFastV>
                       : V == kSmallV
                           ? (const void*)k3_loop_kernel<kSmallV>
                           : (const void*)k3_loop_kernel<0>;
  if (cached_V != V) {
    cudaError_t e;
    if (cl) {  // the clusters that fit on the card at once
      int n = 0;
      if ((e = cl_prepare(kernel, V, true, &n)) != cudaSuccess) return (int)e;
      if (n < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
      cached_ctas = n;
    } else {
      e = gm ? cudaSuccess : set_smem(kernel, smem);
      if (e != cudaSuccess) return (int)e;
      int dev = 0, sms = 0, per_sm = 0;
      if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return (int)e;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
      if (e != cudaSuccess) return (int)e;
      if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
      cached_ctas = per_sm * sms;
    }
    cached_V = V;
  }
  Params p{V, v1, v2, v3, gamma, eps, max_ray};
  int grid = n_rows < cached_ctas ? n_rows : cached_ctas;  // CTAs or clusters
  if (gm && scratch_ctas < grid) grid = scratch_ctas;
  if (grid < 1) return (int)cudaErrorInvalidValue;
  const float* a0 = (const float*)esdf_in;
  float* a1 = (float*)fld;
  const float* a2 = (const float*)enc;
  const int32_t* a3 = (const int32_t*)nsl27;
  const int32_t* a4 = (const int32_t*)upd;
  int32_t* a5 = (int32_t*)ws;
  int32_t* a6 = (int32_t*)stats;
  unsigned char* a7 = (unsigned char*)scratch;
  void* args[] = {&a0, &a1, &a2, &a3, &a4, &a5, &a6, &n_rows, &p,
                  &eps_conv, &max_sweeps, &scan_sweeps, &scan_period, &a7};
  if (cl) {  // the same arguments but the scratch
    cudaLaunchAttribute attrs[2];
    const cudaLaunchConfig_t cfg =
        cl_config(grid * C, C, smem, true, stream, attrs);
    return (int)cudaLaunchKernelExC(&cfg, kernel, args);
  }
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads),
                                          args, smem, (cudaStream_t)stream);
}
