// ESDF relaxation sweeps (Hopper, sm_90a).
//
// K2 replaces taichislam_tpu/ops/pallas/esdf_sweep.py::esdf_sweep_pallas
// (`_kernel`, `_sweep_math`): one Jacobi sweep over the halo-assembled
// sweep layout, rows of (W, W*W) f32 = [j | i*W + k], W = V + 2.
// K3 replaces esdf_sweep_loop_pallas (`_loop_kernel`): the whole sweep loop
// with in-place halo-shell exchange, slab activity gates and a convergence
// exit.
//
// What bounds it on the H100: per row the sweep reads 2 x W^3 f32 (field and
// encoded TSDF) and writes W^3, a few hundred bytes per voxel of stencil and
// scan work all from shared memory, so at the main path's ~264 rows a sweep
// is too small to fill the card and is bound by latency and launch count,
// not by bytes or FLOPs.
//
// Design:
// - One CTA per row. The row's source-masked fields lo/hi (W^3 f32 each),
//   a per-voxel flag byte and the interior scan candidates live in dynamic
//   shared memory (~85 KB at V = 16), so every stencil and scan read is a
//   shared-memory read.
// - The 26-stencil class extrema (faces / edges / corners) are read directly
//   from the neighbours; min and max are exact, so this equals the TPU's
//   chains of separable shifts.
// - The segmented min-plus axis scans run one thread per axis line, scanning
//   sequentially over W. Min is exact, so a sequential scan equals the
//   Hillis-Steele doubling of the Pallas kernel as long as each element is
//   formed by the same rounded steps: x - p*v1, then + p*v1, then + v1. The
//   library is built with --fmad=false so none of these contract into FMAs.
// - Only interior voxels are updated; halo positions pass through (the
//   side mask is interior-only by contract).
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
//   adjacency products without their O(n_slab^2) tables.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kBig = 1e9f;
constexpr float kEncBig = 1e6f;
constexpr int kThreads = 256;

// flag bits per voxel
constexpr uint8_t kFixed = 1, kPsrc = 2, kNsrc = 4, kObs = 8, kNonNeg = 16;

struct Params {
  int V;
  float v1, v2, v3, gamma, eps, max_ray;
};

__host__ __device__ inline size_t smem_bytes(int V) {
  int W = V + 2;
  size_t W3 = (size_t)W * W * W, V3 = (size_t)V * V * V;
  return (2 * W3 + 2 * V3) * sizeof(float) + W3;
}

// One sweep of one row. `side` (K2) gives the update side of each voxel;
// when it is null (K3) the side derives from the flags and `upd`.
// Returns (to thread 0's caller through *changed) whether any voxel moved
// by more than eps_conv.
__device__ void sweep_row(const float* h, const float* enc,
                          const int8_t* side, bool upd, float* out,
                          bool write_halo, const Params& p, bool with_scans,
                          float eps_conv, int* changed) {
  extern __shared__ float smem[];
  const int V = p.V, W = V + 2, W2 = W * W, W3 = W2 * W, V3 = V * V * V;
  float* lo = smem;
  float* hi = lo + W3;
  float* scan_lo = hi + W3;
  float* scan_hi = scan_lo + V3;
  uint8_t* fl = (uint8_t*)(scan_hi + V3);
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int idx = tid; idx < W3; idx += nt) {
    float e = enc[idx];
    float hv = h[idx];
    bool obs = e < kEncBig * 0.5f;
    float t = obs ? e : 0.0f;
    bool fixed = obs && fabsf(t) < p.gamma;
    bool psrc = t >= p.gamma ? obs : fixed;
    bool nsrc = t <= -p.gamma ? obs : fixed;
    lo[idx] = psrc ? hv : kBig;
    hi[idx] = nsrc ? hv : -kBig;
    fl[idx] = (fixed ? kFixed : 0) | (psrc ? kPsrc : 0) |
              (nsrc ? kNsrc : 0) | (obs ? kObs : 0) |
              (t >= 0.0f ? kNonNeg : 0);
    if (write_halo) {
      int j = idx / W2, r = idx - j * W2, i = r / W, k = r - i * W;
      bool halo = j == 0 || j == W - 1 || i == 0 || i == W - 1 || k == 0 ||
                  k == W - 1;
      if (halo) out[idx] = hv;
    }
  }
  __syncthreads();

  if (with_scans) {
    // axis 0: k (stride 1), 1: i (stride W), 2: j (stride W^2)
    const int V2 = V * V;
    for (int axis = 0; axis < 3; ++axis) {
      const int stride = axis == 0 ? 1 : (axis == 1 ? W : W2);
      const int istr = axis == 0 ? 1 : (axis == 1 ? V : V2);  // interior
      for (int task = tid; task < 2 * V2; task += nt) {
        const bool neg = task >= V2;
        const int line = neg ? task - V2 : task;
        const int a = line / V + 1, b = line % V + 1;
        int base, ibase;  // position 0 of the line, interior index of p=1
        if (axis == 0) {  // (j, i) = (a, b)
          base = a * W2 + b * W;
          ibase = ((a - 1) * V + (b - 1)) * V;
        } else if (axis == 1) {  // (j, k) = (a, b)
          base = a * W2 + b;
          ibase = (a - 1) * V2 + (b - 1);
        } else {  // (i, k) = (a, b)
          base = a * W + b;
          ibase = (a - 1) * V + (b - 1);
        }
        const float* src = neg ? hi : lo;
        float* dst = neg ? scan_hi : scan_lo;
        const uint8_t src_bit = neg ? kNsrc : kPsrc;
        float m = kBig;
        // forward: candidate at p+1 from the inclusive min up to p
        for (int q = 0; q < W - 1; ++q) {
          int idx = base + q * stride;
          float x = neg ? -src[idx] : src[idx];
          uint8_t f = fl[idx];
          bool brk = !(f & src_bit) || (f & kFixed) || q == 0;
          float pv = __fmul_rn((float)q, p.v1);
          float y = __fsub_rn(x, pv);
          m = brk ? y : fminf(m, y);
          float c = __fadd_rn(__fadd_rn(m, pv), p.v1);
          if (q + 1 <= V) {
            int di = ibase + q * istr;  // interior index of p = q + 1
            dst[di] = axis == 0 ? c : fminf(dst[di], c);
          }
        }
        // backward: candidate at p-1 from the inclusive min from p up
        for (int q = W - 1; q >= 2; --q) {
          int idx = base + q * stride;
          float x = neg ? -src[idx] : src[idx];
          uint8_t f = fl[idx];
          bool brk = !(f & src_bit) || (f & kFixed) || q == W - 1;
          float pv = __fmul_rn((float)q, p.v1);
          float y = __fadd_rn(x, pv);
          m = brk ? y : fminf(m, y);
          float c = __fadd_rn(__fsub_rn(m, pv), p.v1);
          int di = ibase + (q - 2) * istr;  // interior index of p = q - 1
          dst[di] = fminf(dst[di], c);
        }
      }
      __syncthreads();
    }
  }

  bool moved = false;
  for (int t = tid; t < V3; t += nt) {
    int jj = t / (V * V), r = t - jj * V * V, ii = r / V, kk = r - ii * V;
    int idx = (jj + 1) * W2 + (ii + 1) * W + (kk + 1);
    float hv = h[idx];
    uint8_t f = fl[idx];
    int s;
    if (side) {
      s = side[idx];
    } else {
      s = (upd && (f & kObs) && !(f & kFixed)) ? ((f & kNonNeg) ? 1 : -1)
                                              : 0;
    }
    float nv = hv;
    if (s != 0) {
      const float* a = s > 0 ? lo : hi;
      float fc, ec, cc;
      if (s > 0) {
        fc = ec = cc = kBig;
      } else {
        fc = ec = cc = -kBig;
      }
      for (int dj = -1; dj <= 1; ++dj)
        for (int di = -1; di <= 1; ++di)
          for (int dk = -1; dk <= 1; ++dk) {
            int nz = (dj != 0) + (di != 0) + (dk != 0);
            if (nz == 0) continue;
            float v = a[idx + dj * W2 + di * W + dk];
            if (s > 0) {
              if (nz == 1) fc = fminf(fc, v);
              else if (nz == 2) ec = fminf(ec, v);
              else cc = fminf(cc, v);
            } else {
              if (nz == 1) fc = fmaxf(fc, v);
              else if (nz == 2) ec = fmaxf(ec, v);
              else cc = fmaxf(cc, v);
            }
          }
      if (s > 0) {
        float cand = fminf(fminf(__fadd_rn(fc, p.v1), __fadd_rn(ec, p.v2)),
                           __fadd_rn(cc, p.v3));
        if (with_scans) cand = fminf(cand, scan_lo[t]);
        nv = cand <= __fadd_rn(hv, p.eps) ? fminf(hv, cand)
                                          : fminf(p.max_ray, cand);
      } else {
        float cand = fmaxf(fmaxf(__fsub_rn(fc, p.v1), __fsub_rn(ec, p.v2)),
                           __fsub_rn(cc, p.v3));
        if (with_scans) cand = fmaxf(cand, -scan_hi[t]);
        nv = cand >= __fsub_rn(hv, p.eps) ? fmaxf(hv, cand)
                                          : fmaxf(-p.max_ray, cand);
      }
    }
    if (fabsf(__fsub_rn(nv, hv)) > eps_conv) moved = true;
    out[idx] = nv;
  }
  int any = __syncthreads_or(moved);
  if (changed && tid == 0) *changed = any;
}

__global__ void k2_kernel(const float* esdf, const float* enc,
                          const int8_t* side, const int32_t* slab_act,
                          float* out, Params p, int with_scans) {
  const int W = p.V + 2, W3 = W * W * W;
  const int g = blockIdx.x;
  const size_t off = (size_t)g * W3;
  if (slab_act[g / 8] == 0) {
    for (int i = threadIdx.x; i < W3; i += blockDim.x)
      out[off + i] = esdf[off + i];
    return;
  }
  sweep_row(esdf + off, enc + off, side + off, false, out + off, true, p,
            with_scans != 0, 0.0f, nullptr);
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

__global__ void __launch_bounds__(kThreads, 2) k3_loop_kernel(
    const float* esdf_in, float* fld, const float* enc, const int32_t* nsl,
    const int32_t* upd, int32_t* ws, int32_t* stats, int n_rows, Params p,
    float eps_conv, int max_sweeps, int scan_sweeps, int scan_period) {
  cg::grid_group grid = cg::this_grid();
  const int n_slab = n_rows / 8;
  int32_t* acts = ws;
  int32_t* shell = ws + n_slab;
  int32_t* chg = ws + 3 * n_slab;
  int32_t* changed = ws + 5 * n_slab;
  const int V = p.V, W = V + 2;
  const size_t W3 = (size_t)W * W * W;
  const int64_t gtid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t gstride = (int64_t)gridDim.x * blockDim.x;
  __shared__ int row_changed;

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
    for (int g = blockIdx.x; g < n_rows; g += gridDim.x) {
      const int slab = g / 8;
      if (!acts[slab]) continue;
      if (threadIdx.x == 0 && g % 8 == 0) ++comp;
      if (!upd[g]) continue;  // side is zero on the whole row: a pass-through
      const size_t off = (size_t)g * W3;
      sweep_row(fld + off, enc + off, nullptr, true, fld + off, false, p,
                scans, eps_conv, &row_changed);
      if (threadIdx.x == 0 && row_changed) {
        chg[cur * n_slab + slab] = 1;
        changed[cur] = 1;
      }
      __syncthreads();  // row_changed is reused by the next row
    }
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

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" int esdf_sweep_launch(const void* esdf, const void* enc,
                                 const void* side, const void* slab_act,
                                 void* out, int n_rows, int V, float v1,
                                 float v2, float v3, float gamma, float eps,
                                 float max_ray, int with_scans,
                                 void* stream) {
  static int cached_V = -1;
  Params p{V, v1, v2, v3, gamma, eps, max_ray};
  size_t smem = smem_bytes(V);
  if (cached_V != V) {
    cudaError_t e = set_smem((const void*)k2_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    cached_V = V;
  }
  k2_kernel<<<n_rows, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)esdf, (const float*)enc, (const int8_t*)side,
      (const int32_t*)slab_act, (float*)out, p, with_scans);
  return (int)cudaGetLastError();
}

// The whole loop in one cooperative launch on `stream`: grid = the rows or,
// if fewer, the CTAs that fit on the card at once. The attribute and the
// occupancy are looked up once per process and V.
extern "C" int esdf_loop_launch(const void* esdf_in, void* fld,
                                const void* enc, const void* nsl27,
                                const void* upd, void* ws, void* stats,
                                int n_rows, int V, float v1, float v2,
                                float v3, float gamma, float eps,
                                float max_ray, float eps_conv, int max_sweeps,
                                int scan_sweeps, int scan_period,
                                void* stream) {
  static int cached_V = -1, cached_ctas = 0;
  const size_t smem = smem_bytes(V);
  if (cached_V != V) {
    cudaError_t e = set_smem((const void*)k3_loop_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, k3_loop_kernel, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    cached_ctas = per_sm * sms;
    cached_V = V;
  }
  Params p{V, v1, v2, v3, gamma, eps, max_ray};
  int grid = n_rows < cached_ctas ? n_rows : cached_ctas;
  if (grid < 1) return (int)cudaErrorInvalidValue;
  const float* a0 = (const float*)esdf_in;
  float* a1 = (float*)fld;
  const float* a2 = (const float*)enc;
  const int32_t* a3 = (const int32_t*)nsl27;
  const int32_t* a4 = (const int32_t*)upd;
  int32_t* a5 = (int32_t*)ws;
  int32_t* a6 = (int32_t*)stats;
  void* args[] = {&a0, &a1, &a2, &a3, &a4, &a5, &a6, &n_rows, &p,
                  &eps_conv, &max_sweeps, &scan_sweeps, &scan_period};
  return (int)cudaLaunchCooperativeKernel((const void*)k3_loop_kernel,
                                          dim3(grid), dim3(kThreads), args,
                                          smem, (cudaStream_t)stream);
}
