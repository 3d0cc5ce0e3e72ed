// Sorted segmented block reduction (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel
// taichislam_tpu/ops/pallas/seg_accum.py::segmented_block_reduce
// (body `_kernel`). The TPU version streams sorted lanes through a VMEM
// tile and builds each block's sums as one-hot MXU outer products. Here
// the lanes arrive sorted by the packed key bkey * V3 + intra (the sort
// stays in the PyTorch wrapper, as JAX also sorts outside its kernel), so
// every run of equal keys is one output voxel:
//
//   1. fill: zero the (max_touched, n_vals, V3) tiles, set touched to -1;
//   2. count: each CTA counts the block heads among its lanes
//      (__syncthreads_count);
//   3. scan: one CTA turns those counts into exclusive CTA offsets and
//      writes n_touched (which may exceed max_touched);
//   4. reduce: each lane derives its block's touched rank from an in-CTA
//      prefix of head flags plus its CTA offset; the first lane of each
//      run sums the run sequentially in f32 and writes n_vals sums into
//      the compact tile, the first lane of each block writes touched[rank].
//
// Deterministic: no float atomics, every sum is taken in sorted-lane order.
// Bound: bytes. The kernel reads about N * (8 + 8 + 4 * n_vals) bytes
// (key, permutation, values gathered through the permutation) and writes
// max_touched * n_vals * V3 * 4 bytes of tiles; there is no reuse to
// exploit, so the design keeps one pass over the lanes and one write per
// output voxel. The gather through the sort permutation is uncoalesced;
// a later version can sort the values with the keys instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int64_t kSentinelBlock = 1 << 24;
constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kMaxVals = 8;

__global__ void fill_kernel(float* acc, int64_t n_acc, int32_t* touched,
                            int max_touched) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_acc; i += stride) {
    acc[i] = 0.0f;
  }
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < max_touched; i += stride) {
    touched[i] = -1;
  }
}

__device__ __forceinline__ bool block_head(const int64_t* key, int i,
                                           int64_t V3) {
  int64_t b = key[i] / V3;
  if (b >= kSentinelBlock) return false;
  return i == 0 || key[i - 1] / V3 != b;
}

__global__ void count_kernel(const int64_t* key, int n, int64_t V3,
                             int32_t* cta_counts) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int flag = (i < n) && block_head(key, i, V3);
  int c = __syncthreads_count(flag);
  if (threadIdx.x == 0) cta_counts[blockIdx.x] = c;
}

// one CTA: exclusive scan of cta_counts (in place) and the total
__global__ void scan_kernel(int32_t* cta_counts, int n_cta,
                            int32_t* n_touched) {
  __shared__ int32_t part[kScanThreads];
  int per = (n_cta + kScanThreads - 1) / kScanThreads;
  int lo = threadIdx.x * per;
  int hi = min(lo + per, n_cta);
  int32_t s = 0;
  for (int k = lo; k < hi; ++k) s += cta_counts[k];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    int32_t v = threadIdx.x >= off ? part[threadIdx.x - off] : 0;
    __syncthreads();
    part[threadIdx.x] += v;
    __syncthreads();
  }
  int32_t run = part[threadIdx.x] - s;  // exclusive prefix of this range
  for (int k = lo; k < hi; ++k) {
    int32_t c = cta_counts[k];
    cta_counts[k] = run;
    run += c;
  }
  if (threadIdx.x == kScanThreads - 1) *n_touched = part[kScanThreads - 1];
}

__global__ void reduce_kernel(const int64_t* key, const int64_t* perm,
                              const float* vals, int64_t val_stride, int n,
                              int n_vals, int64_t V3, int max_touched,
                              const int32_t* cta_offs, int32_t* touched,
                              float* acc) {
  __shared__ int32_t warp_tot[kThreads / 32];
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool bh = (i < n) && block_head(key, i, V3);
  // in-CTA inclusive prefix of block heads: warp ballot + warp totals
  unsigned ballot = __ballot_sync(0xffffffffu, bh);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = __popc(ballot & (0xffffffffu >> (31 - lane)));
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_tot[w];
  if (i >= n) return;
  int64_t k = key[i];
  int64_t b = k / V3;
  if (b >= kSentinelBlock) return;
  int rank = cta_offs[blockIdx.x] + before + incl - 1;
  if (rank >= max_touched) return;
  if (bh) touched[rank] = (int32_t)b;
  if (i > 0 && key[i - 1] == k) return;  // not the head of its run
  float s[kMaxVals];
#pragma unroll
  for (int v = 0; v < kMaxVals; ++v) s[v] = 0.0f;
  for (int j = i; j < n && key[j] == k; ++j) {
    int64_t p = perm ? perm[j] : j;
#pragma unroll
    for (int v = 0; v < kMaxVals; ++v) {
      if (v < n_vals) s[v] = __fadd_rn(s[v], vals[v * val_stride + p]);
    }
  }
  int64_t intra = k - b * V3;
  for (int v = 0; v < n_vals; ++v) {
    acc[((int64_t)rank * n_vals + v) * V3 + intra] = s[v];
  }
}

}  // namespace

extern "C" int seg_accum_launch(const void* key, const void* perm,
                                const void* vals, int64_t val_stride,
                                int n_lanes, int n_vals, int64_t V3,
                                int max_touched, void* touched, void* acc,
                                void* n_touched, void* cta_scratch,
                                void* stream) {
  if (n_vals < 1 || n_vals > kMaxVals) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int64_t n_acc = (int64_t)max_touched * n_vals * V3;
  int fill_blocks = (int)((n_acc + kThreads - 1) / kThreads);
  if (fill_blocks > 4096) fill_blocks = 4096;
  if (fill_blocks < 1) fill_blocks = 1;
  fill_kernel<<<fill_blocks, kThreads, 0, st>>>(
      (float*)acc, n_acc, (int32_t*)touched, max_touched);
  int n_cta = (n_lanes + kThreads - 1) / kThreads;
  if (n_cta > 0) {
    count_kernel<<<n_cta, kThreads, 0, st>>>(
        (const int64_t*)key, n_lanes, V3, (int32_t*)cta_scratch);
  }
  scan_kernel<<<1, kScanThreads, 0, st>>>((int32_t*)cta_scratch, n_cta,
                                          (int32_t*)n_touched);
  if (n_cta > 0) {
    reduce_kernel<<<n_cta, kThreads, 0, st>>>(
        (const int64_t*)key, (const int64_t*)perm, (const float*)vals,
        val_stride, n_lanes, n_vals, V3, max_touched,
        (const int32_t*)cta_scratch, (int32_t*)touched, (float*)acc);
  }
  return (int)cudaGetLastError();
}
