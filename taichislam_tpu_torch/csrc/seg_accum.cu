// K1: sorted segmented block reduction (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel
// taichislam_tpu/ops/pallas/seg_accum.py::segmented_block_reduce
// (body `_kernel`, sort `lax.sort` outside it). The TPU version sorts the
// lanes by (block, voxel) with XLA's multi-operand sort, then streams them
// through a VMEM tile and builds each block's sums as one-hot MXU products.
//
// What bounds it on the H100: bytes. Every lane is read once (key parts and
// n_vals values) and every output tile is written once; there is no reuse.
// The design keeps the passes over the lanes few and every pass coalesced,
// and makes one host call issue the whole pipeline on the stream:
//
//   1. k1_init: zero the digit histograms, counters and look-back words of
//      the compaction (one CTA).
//   2. k1_prepare: per 1024-lane tile, validity and the packed key
//      bkey * V3 + intra (u32 when max_bkey * V3 < 2^30, the JAX rule, else
//      u64); the valid lanes are compacted in lane order (warp ballots and a
//      decoupled look-back over the tiles), so invalid lanes never reach
//      the sort: their keys would all sort last and only be cut. Each valid
//      lane writes its key and its values, rounded through f16 in pairs
//      where asked, lane-major as an (n_valid, n_vals) array (staged in
//      shared memory, so a tile's records leave as one run); the CTA adds
//      its keys to the digit histograms of every radix pass, and the last
//      tile stores n_valid. It also zeroes the look-back words of the sort
//      passes and the head scan.
//   3. k1_sort_pass (one per 8-bit digit of the key's live bits): a stable
//      LSD radix pass over the n_valid keys carrying a u32 lane index. Each
//      4096-lane tile ranks its keys per warp with __match_any_sync (stable:
//      warp-striped order equals lane order), gets its digit offsets among
//      the earlier tiles by decoupled look-back, stages the tile in digit
//      order in shared memory and writes it out in runs.
//   4. k1_heads: one scan over the first min(n_valid, lane cap) sorted keys,
//      staged per tile in shared memory as block ids: block heads, their
//      ranks (warp ballots + decoupled look-back), the lane where each of the
//      first max_touched + 1 blocks starts, their block keys (touched),
//      n_touched and lanes_dropped.
//   5. k1_reduce: a CTA per (tile row, 512-voxel slice) writes that part of
//      the (n_vals, V3) tile exactly once, zeros included. Two warps find
//      its slice's lanes by 32-ary search in its block's lane range, one
//      coalesced pass marks each voxel's run from compares of neighbouring
//      keys, and each thread sums its voxel's run in sorted-lane order,
//      reading values through the lane index four lanes at a time.
//
// Deterministic: no float atomics, every voxel's sum is taken in stable
// sorted-lane order, so two calls give bit-identical tiles.
//
// At the per-frame sites (0.08-0.6 M lanes) the call is bound by latency,
// not bytes: 4-8 launches, each a few dependent round trips to memory.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int64_t kSentinelBlock = 1 << 24;
constexpr int kMaxVals = 8;
constexpr int kMaxPasses = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                // keys per thread in a tile
constexpr int kTile = kThreads * kItems;  // 4096 lanes
constexpr int kPrepItems = 4;             // lanes per thread in k1_prepare
constexpr int kPrepTile = kThreads * kPrepItems;  // 1024 lanes
constexpr int kRadix = 256;
constexpr int kSlice = 512;               // voxels of a tile row per CTA
static_assert(kThreads == kRadix, "one thread per digit");

// look-back words: status in the top two bits, a count below
constexpr uint32_t kFlagAgg = 1u << 30;
constexpr uint32_t kFlagPrefix = 2u << 30;
constexpr uint32_t kValueMask = (1u << 30) - 1;

// counters (u32 words after the histograms); 0..7 are the sort passes' tile
// counters
constexpr int kCtrHeadTiles = kMaxPasses;
constexpr int kCtrValid = kMaxPasses + 1;
constexpr int kCtrPrepTiles = kMaxPasses + 2;
constexpr int kNumCtr = 16;

struct Vals {
  const float* p[kMaxVals];
  int64_t stride[kMaxVals];
};

__device__ __forceinline__ uint32_t ld_relaxed(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Exclusive prefix of `x` over the CTA's threads in thread order; `total`
// gets the sum. `scratch` holds kWarps words. Ends with a barrier, so the
// scratch can be reused at once.
__device__ __forceinline__ uint32_t block_excl_scan(uint32_t x,
                                                    uint32_t* scratch,
                                                    uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  uint32_t before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    uint32_t c = scratch[w];
    if (w < warp) before += c;
    all += c;
  }
  __syncthreads();
  if (total) *total = all;
  return before + incl - x;
}

// Decoupled look-back: publish `count` for this tile at `slot` (tile-major
// array of `stride` words per tile) and return the sum of the counts of all
// earlier tiles. Tiles are numbered in the order CTAs started, so every
// earlier tile is running or done and the wait ends. Each round reads the
// next kLookAhead earlier tiles at once: when the tiles start together, the
// nearest published prefix lies about tile / 2 tiles back.
constexpr int kLookAhead = 8;

__device__ __forceinline__ uint32_t look_back(uint32_t* look, int64_t tile,
                                              int64_t stride, int slot,
                                              uint32_t count) {
  uint32_t* mine = look + tile * stride + slot;
  if (tile == 0) {
    st_relaxed(mine, kFlagPrefix | count);
    return 0;
  }
  st_relaxed(mine, kFlagAgg | count);
  uint32_t prev = 0;
  int64_t t = tile - 1;
  while (true) {
    uint32_t v[kLookAhead];
#pragma unroll
    for (int u = 0; u < kLookAhead; ++u) {
      // tile 0 always holds a prefix, so reads stop before t - u < 0
      v[u] = t - u >= 0 ? ld_relaxed(look + (t - u) * stride + slot)
                        : kFlagPrefix;
    }
    int ready = 0;
    bool done = false;
#pragma unroll
    for (int u = 0; u < kLookAhead; ++u) {
      const uint32_t flag = v[u] & ~kValueMask;
      if (done || flag == 0 || ready < u) continue;
      prev += v[u] & kValueMask;
      ready = u + 1;
      done = flag == kFlagPrefix;
    }
    if (done) break;
    t -= ready;  // from the first tile that had not published yet
  }
  st_relaxed(mine, kFlagPrefix | (prev + count));
  return prev;
}

// The same for one count per tile, run by a whole warp: each round reads the
// 32 tiles before the window's top at once and stops at the nearest one
// that has published its inclusive prefix.
__device__ __forceinline__ uint32_t warp_look_back(uint32_t* look,
                                                   int64_t tile,
                                                   uint32_t count) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) st_relaxed(look, kFlagPrefix | count);
    return 0;
  }
  if (lane == 0) st_relaxed(look + tile, kFlagAgg | count);
  uint32_t prev = 0;
  int64_t top = tile - 1;
  while (true) {
    const int64_t t = top - lane;
    // tile 0 always holds a prefix, so lanes before it are never summed
    const uint32_t v = t >= 0 ? ld_relaxed(look + t) : kFlagPrefix;
    const uint32_t flag = v & ~kValueMask;
    const uint32_t pre = __ballot_sync(0xffffffffu, flag == kFlagPrefix);
    const uint32_t idle = __ballot_sync(0xffffffffu, flag == 0);
    // lanes up to the nearest prefix (all 32 when there is none)
    const uint32_t upto = pre ? ((pre & (0u - pre)) << 1) - 1u : 0xffffffffu;
    if (idle & upto) continue;
    uint32_t x = (upto >> lane) & 1u ? v & kValueMask : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    prev += x;
    if (pre) break;
    top -= 32;
  }
  if (lane == 0) st_relaxed(look + tile, kFlagPrefix | (prev + count));
  return prev;
}

__global__ void k1_init(uint32_t* words, int n_words, int32_t* n_touched,
                        int32_t* lanes_dropped) {
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) words[i] = 0;
  if (threadIdx.x == 0) {
    *n_touched = 0;
    *lanes_dropped = 0;
  }
}

// One 1024-lane tile per CTA, in the order CTAs start: warp w holds lanes
// [w * 128, w * 128 + 128) of the tile, item j of lane l at w * 128 + j * 32
// + l, so warp-striped order is lane order and the valid lanes keep it.
// Small tiles keep many CTAs in flight at the per-frame sizes.
template <typename K>
__global__ void __launch_bounds__(kThreads) k1_prepare(
    const int32_t* bkey, const int32_t* intra, Vals vals, int n_vals,
    int n_f16, int64_t N, int64_t V3, int64_t kb, int passes,
    int64_t n_tiles, K* keys, float* vals_lm, uint32_t* hist, uint32_t* ctr,
    uint32_t* prep_look, uint32_t* zero, int64_t n_zero) {
  __shared__ uint32_t s_hist[kMaxPasses * kRadix];
  __shared__ float s_vals[kPrepTile * kMaxVals];
  __shared__ uint32_t s_warp[kWarps];
  __shared__ uint32_t s_prev;
  __shared__ int64_t s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < passes * kRadix; i += kThreads) s_hist[i] = 0;
  if (tid == 0) s_tile = atomicAdd(&ctr[kCtrPrepTiles], 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t wbase = tile * kPrepTile + (int64_t)warp * (kPrepItems * 32);
  const uint32_t lt = (1u << lane) - 1u;
  K key[kPrepItems];
  uint32_t rank[kPrepItems];
  float x[kPrepItems][kMaxVals];  // loaded before the look-back waits
  uint32_t valid_bits = 0, wcount = 0;
#pragma unroll
  for (int j = 0; j < kPrepItems; ++j) {
    const int64_t pos = wbase + j * 32 + lane;
    bool valid = false;
    key[j] = 0;
    rank[j] = 0;
    if (pos < N) {
      const int32_t b = bkey[pos];
      const int32_t c = intra[pos];
      valid = b < kb;
      key[j] = (K)b * (K)V3 + (K)c;
    }
#pragma unroll
    for (int v = 0; v < kMaxVals; ++v) {
      x[j][v] = valid && v < n_vals ? vals.p[v][pos * vals.stride[v]] : 0.0f;
    }
    const uint32_t bal = __ballot_sync(0xffffffffu, valid);
    if (valid) {
      valid_bits |= 1u << j;
      rank[j] = wcount + __popc(bal & lt);
      for (int p = 0; p < passes; ++p) {
        atomicAdd(&s_hist[p * kRadix + (uint32_t)((key[j] >> (8 * p)) & 255)],
                  1u);
      }
    }
    wcount += __popc(bal);
  }
  if (lane == 0) s_warp[warp] = wcount;
  __syncthreads();
  uint32_t wexcl = 0, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = s_warp[w];
    if (w < warp) wexcl += c;
    total += c;
  }
  if (warp == 0) {
    const uint32_t prev = warp_look_back(prep_look, tile, total);
    if (lane == 0) {
      s_prev = prev;
      if (tile == n_tiles - 1) ctr[kCtrValid] = prev + total;
    }
  }
  for (int64_t i = tile * kThreads + tid; i < n_zero; i += n_tiles * kThreads)
    zero[i] = 0;
  __syncthreads();
  // keys straight out; the values staged so that the tile's records leave
  // as one contiguous run
#pragma unroll
  for (int j = 0; j < kPrepItems; ++j) {
    if (valid_bits & (1u << j)) {
      const uint32_t o = wexcl + rank[j];
      keys[s_prev + o] = key[j];
#pragma unroll
      for (int v = 0; v < kMaxVals; ++v) {
        if (v < n_vals) {
          s_vals[o * n_vals + v] =
              v < n_f16 ? __half2float(__float2half_rn(x[j][v])) : x[j][v];
        }
      }
    }
  }
  __syncthreads();
  float* dst = vals_lm + (int64_t)s_prev * n_vals;
  for (uint32_t i = tid; i < total * n_vals; i += kThreads) dst[i] = s_vals[i];
  for (int i = tid; i < passes * kRadix; i += kThreads) {
    if (s_hist[i]) atomicAdd(&hist[i], s_hist[i]);
  }
}

template <typename K>
constexpr size_t sort_smem_bytes() {
  return (size_t)kTile * (sizeof(K) + 4) +
         (size_t)(kWarps * kRadix + 2 * kRadix) * 4;
}

// One stable radix pass on the digit (key >> shift) & 255 over the n_valid
// compacted keys; CTAs past them leave at once. `idx_in` null means the
// identity (the first pass).
template <typename K>
__global__ void __launch_bounds__(kThreads) k1_sort_pass(
    const K* keys_in, const uint32_t* idx_in, K* keys_out, uint32_t* idx_out,
    const uint32_t* ctr, int shift, const uint32_t* hist, uint32_t* look,
    uint32_t* tile_ctr) {
  extern __shared__ __align__(16) unsigned char smem[];
  K* s_keys = (K*)smem;
  uint32_t* s_idx = (uint32_t*)(s_keys + kTile);
  uint32_t* s_whist = s_idx + kTile;          // [warp][digit]
  uint32_t* s_local = s_whist + kWarps * kRadix;  // tile-local digit offset
  uint32_t* s_base = s_local + kRadix;        // output base minus it
  __shared__ uint32_t s_scan[kWarps];
  __shared__ int64_t s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(tile_ctr, 1u);
  for (int i = tid; i < kWarps * kRadix; i += kThreads) s_whist[i] = 0;
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t N = ctr[kCtrValid];
  if (tile * kTile >= N) return;
  const int64_t wbase = tile * kTile + (int64_t)warp * (kItems * 32);
  uint32_t* wh = s_whist + warp * kRadix;
  const uint32_t lt = (1u << lane) - 1u;
  K key[kItems];
  uint32_t idx[kItems], rank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t pos = wbase + j * 32 + lane;
    const bool ok = pos < N;
    key[j] = ok ? keys_in[pos] : (K)0;
    idx[j] = ok ? (idx_in ? idx_in[pos] : (uint32_t)pos) : 0u;
    const uint32_t d = ok ? (uint32_t)((key[j] >> shift) & 255) : 256u;
    const uint32_t peers = __match_any_sync(0xffffffffu, d);
    const int leader = __ffs(peers) - 1;
    uint32_t old = 0;
    if (ok && lane == leader) {
      old = wh[d];
      wh[d] = old + __popc(peers);
    }
    old = __shfl_sync(0xffffffffu, old, leader);
    rank[j] = old + __popc(peers & lt);
    __syncwarp();
  }
  __syncthreads();
  // per digit (thread = digit): exclusive prefix over the warps
  const int d = tid;
  uint32_t count = 0;
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t c = s_whist[w * kRadix + d];
    s_whist[w * kRadix + d] = count;
    count += c;
  }
  const uint32_t local = block_excl_scan(count, s_scan, nullptr);
  const uint32_t global = block_excl_scan(hist[d], s_scan, nullptr);
  const uint32_t prev = look_back(look, tile, kRadix, d, count);
  s_local[d] = local;
  s_base[d] = global + prev - local;  // mod 2^32; base + local pos >= 0
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t pos = wbase + j * 32 + lane;
    if (pos < N) {
      const uint32_t dd = (uint32_t)((key[j] >> shift) & 255);
      const uint32_t p = s_local[dd] + s_whist[warp * kRadix + dd] + rank[j];
      s_keys[p] = key[j];
      s_idx[p] = idx[j];
    }
  }
  __syncthreads();
  const int64_t rest = N - tile * kTile;
  const int n_here = rest < kTile ? (int)rest : kTile;
  for (int i = tid; i < n_here; i += kThreads) {
    const K k = s_keys[i];
    const uint32_t o = s_base[(uint32_t)((k >> shift) & 255)] + (uint32_t)i;
    keys_out[o] = k;
    idx_out[o] = s_idx[i];
  }
}

// Block heads of the first n = min(n_valid, n_cap) sorted keys: starts[rank]
// = first lane of the block of that rank, for ranks <= max_touched;
// touched[rank] = its block key, for ranks < max_touched; n_touched;
// lanes_dropped when the lanes were capped. Each tile stages the
// block ids of its keys (and of the key before it) in shared memory.
template <typename K>
__global__ void __launch_bounds__(kThreads) k1_heads(
    const K* keys, int64_t n_cap, int64_t V3, int max_touched, int capping,
    uint32_t* look, uint32_t* ctr, int32_t* starts, int32_t* touched,
    int32_t* n_touched, int32_t* lanes_dropped) {
  __shared__ uint32_t s_blk[kTile + 1];
  __shared__ uint32_t s_scan[kWarps];
  __shared__ uint32_t s_prev;
  __shared__ int64_t s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(&ctr[kCtrHeadTiles], 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t n_valid = ctr[kCtrValid];
  const int64_t n = n_valid < n_cap ? n_valid : n_cap;
  if (tile == 0 && tid == 0 && capping) {
    *lanes_dropped = n_valid > n_cap ? (int32_t)(n_valid - n_cap) : 0;
  }
  const int64_t start = tile * kTile;
  if (start >= n) return;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  for (int i = tid; i <= kTile; i += kThreads) {
    const int64_t pos = start - 1 + i;  // s_blk[0] is the key before
    s_blk[i] = pos >= 0 && pos < n ? (uint32_t)(keys[pos] / (K)V3)
                                   : 0xffffffffu;
  }
  __syncthreads();
  const int local0 = warp * (kItems * 32);
  const uint32_t lt = (1u << lane) - 1u;
  uint32_t heads = 0, wcount = 0;
  uint32_t wrank[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int l = local0 + j * 32 + lane;
    const bool head = start + l < n && s_blk[l] != s_blk[l + 1];
    const uint32_t bal = __ballot_sync(0xffffffffu, head);
    wrank[j] = 0;
    if (head) {
      heads |= 1u << j;
      wrank[j] = wcount + __popc(bal & lt);
    }
    wcount += __popc(bal);
  }
  // warp totals -> tile-local warp offsets -> tile offset by look-back
  if (lane == 0) s_scan[warp] = wcount;
  __syncthreads();
  uint32_t wexcl = 0, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) wexcl += s_scan[w];
    total += s_scan[w];
  }
  if (warp == 0) {
    const uint32_t prev = warp_look_back(look, tile, total);
    if (lane == 0) {
      s_prev = prev;
      if (tile == n_tiles - 1) *n_touched = (int32_t)(prev + total);
    }
  }
  __syncthreads();
  const uint32_t base = s_prev + wexcl;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (heads & (1u << j)) {
      const uint32_t r = base + wrank[j];
      const int l = local0 + j * 32 + lane;
      if (r <= (uint32_t)max_touched) starts[r] = (int32_t)(start + l);
      if (r < (uint32_t)max_touched) touched[r] = (int32_t)s_blk[l + 1];
    }
  }
}

// First index in [l, h) whose key is >= target, or h, for ascending keys;
// the whole warp calls it. Each round probes 32 evenly spaced keys.
template <typename K>
__device__ __forceinline__ int64_t warp_lower_bound(const K* keys, int64_t l,
                                                    int64_t h, K target) {
  const int lane = threadIdx.x & 31;
  while (h - l > 32) {  // the answer lies in [l, h]
    const int64_t step = (h - l + 31) / 32;
    const int64_t p = l + (int64_t)(lane + 1) * step - 1;
    const bool less = p < h && keys[p] < target;
    const int c = __popc(__ballot_sync(0xffffffffu, less));
    const int64_t nh = l + (int64_t)(c + 1) * step - 1;
    l += (int64_t)c * step;
    if (nh < h) h = nh;
  }
  const int64_t p = l + lane;
  const bool less = p < h && keys[p] < target;
  return l + __popc(__ballot_sync(0xffffffffu, less));
}

constexpr int kUnroll = 4;  // lanes of a run summed per step

// One CTA per (tile row r, voxel slice): writes acc[r, :, slice] once.
template <typename K>
__global__ void __launch_bounds__(kThreads) k1_reduce(
    const K* keys, const uint32_t* idx, const float* vals_lm, int n_vals,
    int64_t V3, int64_t n_cap, const int32_t* starts,
    const int32_t* n_touched, const uint32_t* ctr, int32_t* touched,
    float* acc) {  // touched[r] < n_touched comes from k1_heads
  __shared__ int32_t s_lo[kSlice], s_hi[kSlice];
  __shared__ int64_t s_range[2];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int r = blockIdx.x;
  const int64_t v0 = (int64_t)blockIdx.y * kSlice;
  const int nv = (int)(V3 - v0 < kSlice ? V3 - v0 : kSlice);
  float* out = acc + (int64_t)r * n_vals * V3 + v0;
  const int nt = *n_touched;
  if (r >= nt) {
    for (int v = 0; v < n_vals; ++v) {
      for (int t = tid; t < nv; t += kThreads) out[v * V3 + t] = 0.0f;
    }
    if (blockIdx.y == 0 && tid == 0) touched[r] = -1;
    return;
  }
  const int64_t n_valid = ctr[kCtrValid];
  const int64_t lo = starts[r];
  const int64_t hi = r + 1 < nt ? (int64_t)starts[r + 1]
                                : (n_valid < n_cap ? n_valid : n_cap);
  const K kbase = (K)touched[r] * (K)V3 + (K)v0;
  if (warp < 2) {  // lanes of this slice: [lower(v0), lower(v0 + nv))
    const int64_t at = warp_lower_bound(keys, lo, hi,
                                        kbase + (warp ? (K)nv : (K)0));
    if ((tid & 31) == 0) s_range[warp] = at;
  }
  for (int t = tid; t < nv; t += kThreads) {
    s_lo[t] = 0;
    s_hi[t] = 0;
  }
  __syncthreads();
  const int64_t a = s_range[0], e = s_range[1];
  const K none = ~(K)0;
  for (int64_t j = a + tid; j < e; j += kThreads) {
    const K k = keys[j];
    const K kp = j > a ? keys[j - 1] : none;
    const K kn = j + 1 < e ? keys[j + 1] : none;
    const int t = (int)(k - kbase);
    if (kp != k) s_lo[t] = (int32_t)j;
    if (kn != k) s_hi[t] = (int32_t)(j + 1);
  }
  __syncthreads();
  for (int t = tid; t < nv; t += kThreads) {
    float s[kMaxVals];
#pragma unroll
    for (int v = 0; v < kMaxVals; ++v) s[v] = 0.0f;
    const int j1 = s_hi[t];
    for (int j = s_lo[t]; j < j1; j += kUnroll) {
      // the next kUnroll lanes' loads go out together; the sums stay in
      // sorted-lane order
      float x[kUnroll][kMaxVals];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int ju = j + u < j1 ? j + u : j;
        const uint32_t li = idx ? idx[ju] : (uint32_t)ju;
        const float* src = vals_lm + (int64_t)li * n_vals;
#pragma unroll
        for (int v = 0; v < kMaxVals; ++v) x[u][v] = v < n_vals ? src[v] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u < j1) {
#pragma unroll
          for (int v = 0; v < kMaxVals; ++v) s[v] = __fadd_rn(s[v], x[u][v]);
        }
      }
    }
    for (int v = 0; v < n_vals; ++v) out[v * V3 + t] = s[v];
  }
}

size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

// Workspace layout; the wrapper's `_workspace_bytes` mirrors it.
struct Layout {
  size_t keys_a, keys_b, idx_a, idx_b, vals, hist, ctr, prep_look, look,
      head_look, starts, total;
};

Layout layout(int64_t N, int64_t n, int n_vals, int key_bytes, int passes,
              int max_touched) {
  Layout L;
  size_t o = 0;
  auto take = [&o](size_t bytes) {
    size_t at = o;
    o = align256(o + bytes);
    return at;
  };
  const int64_t tiles = (N + kTile - 1) / kTile;
  const int64_t prep_tiles = (N + kPrepTile - 1) / kPrepTile;
  const int64_t head_tiles = (n + kTile - 1) / kTile;
  L.keys_a = take((size_t)N * key_bytes);
  L.keys_b = take(passes > 0 ? (size_t)N * key_bytes : 0);
  L.idx_a = take(passes > 1 ? (size_t)N * 4 : 0);
  L.idx_b = take(passes > 0 ? (size_t)N * 4 : 0);
  L.vals = take((size_t)N * n_vals * 4);
  L.hist = take((size_t)kMaxPasses * kRadix * 4);
  L.ctr = take((size_t)kNumCtr * 4);
  L.prep_look = take((size_t)prep_tiles * 4);
  L.look = take((size_t)passes * tiles * kRadix * 4);
  L.head_look = take((size_t)head_tiles * 4);
  L.starts = take((size_t)(max_touched + 1) * 4);
  L.total = o;
  return L;
}

template <typename K>
cudaError_t run(const int32_t* bkey, const int32_t* intra, const Vals& vals,
                int64_t N, int n_vals, int n_f16, int64_t V3, int64_t kb,
                int passes, int64_t n, int capping, int max_touched,
                int32_t* touched, float* acc, int32_t* n_touched,
                int32_t* lanes_dropped, char* ws, const Layout& L,
                cudaStream_t st) {
  static bool attr_set = false;
  const size_t smem = sort_smem_bytes<K>();
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)k1_sort_pass<K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  K* keys_a = (K*)(ws + L.keys_a);
  K* keys_b = (K*)(ws + L.keys_b);
  uint32_t* idx_a = (uint32_t*)(ws + L.idx_a);
  uint32_t* idx_b = (uint32_t*)(ws + L.idx_b);
  float* vals_lm = (float*)(ws + L.vals);
  uint32_t* hist = (uint32_t*)(ws + L.hist);
  uint32_t* ctr = (uint32_t*)(ws + L.ctr);
  uint32_t* prep_look = (uint32_t*)(ws + L.prep_look);
  uint32_t* look = (uint32_t*)(ws + L.look);
  uint32_t* head_look = (uint32_t*)(ws + L.head_look);
  int32_t* starts = (int32_t*)(ws + L.starts);
  const int64_t tiles = (N + kTile - 1) / kTile;
  const int64_t head_tiles = (n + kTile - 1) / kTile;

  // hist, ctr and prep_look are contiguous: k1_init zeroes them; look and
  // head_look are contiguous: k1_prepare zeroes them
  k1_init<<<1, kThreads, 0, st>>>(hist, (int)((L.look - L.hist) / 4),
                                  n_touched, lanes_dropped);
  const int64_t prep_tiles = (N + kPrepTile - 1) / kPrepTile;
  if (prep_tiles > 0) {
    k1_prepare<K><<<(unsigned)prep_tiles, kThreads, 0, st>>>(
        bkey, intra, vals, n_vals, n_f16, N, V3, kb, passes, prep_tiles, keys_a,
        vals_lm, hist, ctr, prep_look, look,
        (int64_t)((L.starts - L.look) / 4));
  }
  const K* kin = keys_a;
  const uint32_t* iin = nullptr;
  for (int p = 0; p < passes && tiles > 0; ++p) {
    K* kout = (p % 2 == 0) ? keys_b : keys_a;
    uint32_t* iout = (p % 2 == 0) ? idx_b : idx_a;
    k1_sort_pass<K><<<(unsigned)tiles, kThreads, smem, st>>>(
        kin, iin, kout, iout, ctr, 8 * p, hist + p * kRadix,
        look + (int64_t)p * tiles * kRadix, ctr + p);
    kin = kout;
    iin = iout;
  }
  if (head_tiles > 0) {
    k1_heads<K><<<(unsigned)head_tiles, kThreads, 0, st>>>(
        kin, n, V3, max_touched, capping, head_look, ctr, starts, touched,
        n_touched, lanes_dropped);
  }
  if (max_touched > 0) {
    dim3 grid((unsigned)max_touched, (unsigned)((V3 + kSlice - 1) / kSlice));
    k1_reduce<K><<<grid, kThreads, 0, st>>>(kin, iin, vals_lm, n_vals, V3, n,
                                            starts, n_touched, ctr, touched,
                                            acc);
  }
  return cudaGetLastError();
}

}  // namespace

// One call runs the whole reduction on `stream`. `kb` bounds the valid block
// keys (max_bkey, or 2^24); lanes with bkey >= kb are invalid. The key is
// u32 (`key_bytes` 4) or u64 (8); `passes` 8-bit radix passes cover its live
// bits, 0 for presorted lanes. Of the sorted valid lanes, the first `n` (the
// lane cap, or N) are reduced; `capping` says the lane cap was set below N. `ws` is the wrapper's workspace of
// `ws_bytes` bytes.
extern "C" int seg_accum_launch(
    const void* bkey, const void* intra, void* const* val_ptrs,
    const int64_t* val_strides, int64_t N, int n_vals, int n_f16, int64_t V3,
    int64_t kb, int key_bytes, int passes, int64_t n, int capping,
    int max_touched, void* touched, void* acc, void* n_touched,
    void* lanes_dropped, void* ws, int64_t ws_bytes, void* stream) {
  if (n_vals < 1 || n_vals > kMaxVals || passes < 0 || passes > kMaxPasses ||
      N >= (int64_t)kValueMask || n > N || max_touched < 0 ||
      (key_bytes != 4 && key_bytes != 8) || kb > kSentinelBlock) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L = layout(N, n, n_vals, key_bytes, passes, max_touched);
  if ((size_t)ws_bytes < L.total) return (int)cudaErrorInvalidValue;
  Vals vals{};
  for (int v = 0; v < n_vals; ++v) {
    vals.p[v] = (const float*)val_ptrs[v];
    vals.stride[v] = val_strides[v];
  }
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (key_bytes == 4) {
    e = run<uint32_t>((const int32_t*)bkey, (const int32_t*)intra, vals, N,
                      n_vals, n_f16, V3, kb, passes, n, capping, max_touched,
                      (int32_t*)touched, (float*)acc, (int32_t*)n_touched,
                      (int32_t*)lanes_dropped, (char*)ws, L, st);
  } else {
    e = run<uint64_t>((const int32_t*)bkey, (const int32_t*)intra, vals, N,
                      n_vals, n_f16, V3, kb, passes, n, capping, max_touched,
                      (int32_t*)touched, (float*)acc, (int32_t*)n_touched,
                      (int32_t*)lanes_dropped, (char*)ws, L, st);
  }
  return (int)e;
}
