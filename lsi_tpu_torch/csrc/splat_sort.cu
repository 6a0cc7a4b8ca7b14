// Deterministic forward bilinear splat for Hopper (sm_90a): K1-D.
//
// Replaces the sort branch of lsi_tpu/ops/splat.py:splat_bilinear
// (method="sort", lsi_tpu/ops/splat.py:145): a stable argsort of the flat
// corner targets, corner-major (4, N, P), then a segment sum of each
// target's run in that order. It is the same function as K1
// (csrc/splat_fwd.cu, csrc/splat_band.cu), unwindowed or with the TPU
// kernel's vertical window, but bitwise repeatable: K1 adds float32
// atomics, whose order, and so whose rounding, changes from launch to
// launch (ROADMAP H8); here every target pixel adds its contributions in
// one fixed order, ascending corner position q = k * N * P + i (corner k,
// source pixel i = n * P + p), from 0.0, with no float atomics. The plain
// version beside this kernel is lsi_tpu_torch/ops/splat.py
// (method="sort").
//
// What bounds it. The function's own bytes are K1's (values, coords and
// weights read once, accum and wsum written once: 35.7 us on the b8
// render's inputs (8, 512, 768, 4) -> (256, 768) at 3.35 TB/s). The fixed
// order costs a sort of the corners by target. A radix sort of every
// corner, dropped ones included, with a 32-bit key and an int64 position
// moves ~12 bytes a corner in and out over four passes (~1.2 GB on the
// render's 12.6M corners), and a thread a target that binary-searches the
// sorted keys and then walks its run alone waits for the longest run of
// its warp. This design sorts only the live corners, by a counting sort
// whose bins are the targets themselves, and fixes the order inside each
// run where the run is summed. What is left is scattered: the count's and
// the fill's integer atomics, the fill's 4-byte stores, each lane of a
// warp into its own target's run, and the sum's gathers of coordinates,
// values and weights by position. On an H100 (PERF.md §6) the fill's
// stores and the sum's gathers take most of a call where runs are long
// (the quality step's three layers); the sort networks cost little.
//
//   1. count (splat_sort_count_kernel): one thread a source pixel applies
//      K1's corner test (csrc/splat_fwd.cu:corners: the bounds tested in
//      float before any conversion (H9), a NaN fails every test (H11), a
//      corner with fraction 0 is dropped, and with max_dy >= 0 the window
//      [base - max_dy, base + max_dy + 1], base = r % fold_h +
//      base_offset) and adds each live corner to its target's int32
//      count. Integer adds commute, so the counts do not depend on the
//      order of the atomics. Neighbouring sources often hit one target
//      (18-25% of a warp's corners, PERF.md §6, PR 10), so a warp adds one
//      atomic for each run of equal targets among consecutive lanes.
//   2. scan (splat_sort_scan_{reduce,tiles,apply}_kernel): an exclusive
//      scan of the counts, in place, gives each target's start: tile sums,
//      a scan of the tile sums in one block, then each tile rescanned from
//      its offset. ~12 bytes a target.
//   3. fill (splat_sort_fill_kernel): the corner test again; each live
//      corner takes the next slot of its target's run (the same warp
//      aggregation, an atomic that returns the slot; a thread's four in
//      flight together) and writes its int32 position q there: 4 bytes a
//      live corner. After it, cursor[t] is the end of t's run and
//      cursor[t - 1] its start. The order inside a run is the atomics'
//      order, which step 4 does not use.
//   4. sum (splat_sort_sum_kernel): one thread a target reads its run from
//      the cursors (no search), sorts the run's positions in registers
//      with a bitonic network sized by its warp's longest run (8, 16 or
//      kShortRun), and adds the contributions in ascending q (with C = 4
//      a pixel's values are one float4 load where they are 16-byte
//      aligned). A run longer than kShortRun is listed instead, and
//   5. long (splat_sort_long_kernel) gives each listed target a warp: the
//      lanes sort the run in shared memory (in place in `pos` beyond
//      kLongRun positions) with a bitonic network for any length, form 32
//      contributions at a time in parallel, and every lane adds them in
//      rank order from the others' registers, so the order, and every bit,
//      is the thread path's. A warp never waits for one lane's long run.
//
// The arithmetic of steps 4 and 5 is PR 11's: each contribution is
// recomputed from its position (the corner's fraction from the
// coordinates, w * frac and (v * w) * frac as the plain version forms
// them) and added with __fadd_rn/__fmul_rn, which the compiler may not
// contract into FMAs, so the products and sums are the plain version's;
// a denormal sum is flushed to zero as K1's global atomics flush it
// (H12). Every pixel of accum and wsum is written with a plain store, so
// the wrapper allocates them with torch.empty.
//
// Offsets: positions and targets are int32, so N * out_h * out_w must be
// below INT_MAX and 4 * N * src_h * src_w below 2^31 (the wrapper raises
// ValueError otherwise); value and output offsets are int64.
//
// Plain C interface (loaded with ctypes): lsi_splat_sort launches every
// step on the calling thread's current device and stream and returns the
// first non-zero cudaGetLastError() after a launch, 0 on success.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kMinFraction = 1e-4f;  // ops/splat.py MIN_FRACTION
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// The longest run a thread sums (splat_cuda.SORT_SHORT_RUN); longer runs
// take a warp.
constexpr int kShortRun = 32;
// Positions a warp sorts in shared memory (splat_cuda.SORT_LONG_RUN);
// longer runs are sorted in place in global memory.
constexpr int kLongRun = 512;
// Targets a block of the scan covers (splat_cuda.SORT_SCAN_TILE).
constexpr int kScanTile = 16 * kThreads;

__device__ __forceinline__ float snap_fraction(float f) {
  if (f < kMinFraction) return 0.0f;
  if (f > 1.0f - kMinFraction) return 1.0f;
  return f;
}

// The floor of a coordinate and its (snapped) fractions.
template <bool SNAP>
__device__ __forceinline__ void fractions(float2 c, float& x0, float& y0,
                                          float& fx, float& fy) {
  x0 = floorf(c.x);
  y0 = floorf(c.y);
  fx = __fsub_rn(c.x, x0);
  fy = __fsub_rn(c.y, y0);
  if (SNAP) {
    fx = snap_fraction(fx);
    fy = snap_fraction(fy);
  }
}

// Corner k's bilinear fraction (00, 01 = x + 1, 10 = y + 1, 11), formed as
// ops/splat.py forms it: (1 - fx)(1 - fy), fx (1 - fy), (1 - fx) fy, fx fy.
__device__ __forceinline__ float corner_fraction(int k, float fx, float fy) {
  const float ax = (k & 1) ? fx : __fsub_rn(1.0f, fx);
  const float ay = (k >> 1) ? fy : __fsub_rn(1.0f, fy);
  return __fmul_rn(ax, ay);
}

// x + 0 with denormals flushed (add.rn.ftz.f32, as the box kernel's global
// atomics flush a pixel's sum).
__device__ __forceinline__ float flushed(float x) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(x));
  return r;
}

// The splat's shape.
struct Geometry {
  int64_t np;
  int src_h, src_w, out_h, out_w, max_dy, fold_h, base_offset;
};

// The corner test of steps 1 and 3. Source pixel i's four corner targets
// (the flat index n * out_h * out_w + y * out_w + x), -1 where a corner
// is dropped; all -1 for i >= np.
template <bool SNAP>
__device__ __forceinline__ void corner_targets(const float2* coords,
                                               int64_t i, const Geometry& g,
                                               int (&t)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) t[k] = -1;
  if (i >= g.np) return;
  const int64_t pixels = static_cast<int64_t>(g.src_h) * g.src_w;
  const int64_t n = i / pixels;
  const int row = static_cast<int>((i - n * pixels) / g.src_w);
  const int base = row % g.fold_h + g.base_offset;
  float x0, y0, fx, fy;
  fractions<SNAP>(coords[i], x0, y0, fx, fy);
  const int image = static_cast<int>(n) * g.out_h * g.out_w;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float xf = x0 + static_cast<float>(k & 1);
    const float yf = y0 + static_cast<float>(k >> 1);
    // NaN coordinates fail every comparison and are dropped too.
    bool live = corner_fraction(k, fx, fy) > 0.0f && xf >= 0.0f &&
                xf <= static_cast<float>(g.out_w - 1) && yf >= 0.0f &&
                yf <= static_cast<float>(g.out_h - 1);
    if (g.max_dy >= 0) {
      // Exact in float: it decides only for rows inside the target.
      const float ky = yf - static_cast<float>(base);
      live = live && ky >= static_cast<float>(-g.max_dy) &&
             ky <= static_cast<float>(g.max_dy + 1);
    }
    if (live) {
      t[k] = image + static_cast<int>(yf) * g.out_w + static_cast<int>(xf);
    }
  }
}

// A warp's runs of equal targets among consecutive lanes: this lane's
// rank in its run and the run's first lane and length. Every lane of the
// warp calls it.
__device__ __forceinline__ void lane_run(int t, int lane, int& rank,
                                         int& head, int& size) {
  const int prev = __shfl_up_sync(kFull, t, 1);
  const unsigned starts = __ballot_sync(kFull, lane == 0 || prev != t);
  head = 31 - __clz(starts & (0xffffffffu >> (31 - lane)));
  const unsigned after = starts & ~(0xffffffffu >> (31 - lane));
  size = (after ? __ffs(after) - 1 : 32) - head;
  rank = lane - head;
}

template <bool SNAP>
__global__ void __launch_bounds__(kThreads)
    splat_sort_count_kernel(const float2* __restrict__ coords,
                            int* __restrict__ cursor, Geometry g) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  const int lane = threadIdx.x & 31;
  int t[4];
  corner_targets<SNAP>(coords, i, g, t);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int rank, head, size;
    lane_run(t[k], lane, rank, head, size);
    if (t[k] >= 0 && rank == 0) atomicAdd(&cursor[t[k]], size);
  }
}

template <bool SNAP>
__global__ void __launch_bounds__(kThreads)
    splat_sort_fill_kernel(const float2* __restrict__ coords,
                           int* __restrict__ cursor, int* __restrict__ pos,
                           Geometry g) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  const int lane = threadIdx.x & 31;
  int t[4], rank[4], head[4], size[4], slot[4];
  corner_targets<SNAP>(coords, i, g, t);
#pragma unroll
  for (int k = 0; k < 4; ++k) lane_run(t[k], lane, rank[k], head[k], size[k]);
  // The four atomics are in flight together.
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    slot[k] = t[k] >= 0 && rank[k] == 0 ? atomicAdd(&cursor[t[k]], size[k])
                                        : 0;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int at = __shfl_sync(kFull, slot[k], head[k]) + rank[k];
    if (t[k] >= 0) pos[at] = static_cast<int>(k * g.np + i);
  }
}

// The block's inclusive scan of v (every thread calls it); *total gets the
// block's sum.
__device__ __forceinline__ int block_scan(int v, int* total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int u = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += u;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  *total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return v;
}

__global__ void __launch_bounds__(kThreads)
    splat_sort_scan_reduce_kernel(const int* __restrict__ counts,
                                  int* __restrict__ tile_sums, int targets) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile;
  int s = 0;
  for (int j = threadIdx.x; j < kScanTile; j += kThreads) {
    if (base + j < targets) s += counts[base + j];
  }
  int total;
  block_scan(s, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// One block: the tile sums -> their exclusive scan, in place.
__global__ void __launch_bounds__(kThreads)
    splat_sort_scan_tiles_kernel(int* __restrict__ tile_sums, int tiles) {
  int carry = 0;
  for (int base = 0; base < tiles; base += kThreads) {
    const int j = base + threadIdx.x;
    const int v = j < tiles ? tile_sums[j] : 0;
    int total;
    const int incl = block_scan(v, &total);
    if (j < tiles) tile_sums[j] = carry + incl - v;
    carry += total;
  }
}

// Each tile's counts -> their exclusive scan from the tile's offset.
__global__ void __launch_bounds__(kThreads)
    splat_sort_scan_apply_kernel(int* __restrict__ counts,
                                 const int* __restrict__ tile_sums,
                                 int targets) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile;
  int carry = tile_sums[blockIdx.x];
  for (int j = 0; j < kScanTile; j += kThreads) {
    const int64_t idx = base + j + threadIdx.x;
    const int v = idx < targets ? counts[idx] : 0;
    int total;
    const int incl = block_scan(v, &total);
    if (idx < targets) counts[idx] = carry + incl - v;
    carry += total;
  }
}

__device__ __forceinline__ void order2(int& a, int& b) {
  const int lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// Sorts p[0, N) ascending in registers: a bitonic network whose every
// compare-exchange puts the smaller value at the lower index (the first
// step of each merge compares mirrored pairs), so padding with INT_MAX
// past a run's end leaves the run in p[0, length).
template <int N>
__device__ __forceinline__ void sort_registers(int (&p)[kShortRun]) {
#pragma unroll
  for (int block = 2; block <= N; block <<= 1) {
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const int half = block / 2;
      const int first = (j / half) * block;
      order2(p[first + j % half], p[first + block - 1 - j % half]);
    }
#pragma unroll
    for (int h = block / 4; h > 0; h /= 2) {
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        const int lo = (j / h) * 2 * h + j % h;
        order2(p[lo], p[lo + h]);
      }
    }
  }
}

// The same network over a run of any length in shared or global memory,
// by one warp: each step's pairs are disjoint, split over the lanes;
// positions past `length` count as INT_MAX and are never touched.
__device__ void sort_warp(volatile int* a, int length, int lane) {
  int width = 1;
  while (width < length) width <<= 1;
  for (int lg = 0; (2 << lg) <= width; ++lg) {
    // Blocks of 2 << lg: mirrored pairs, then half-cleaners.
    for (int h = lg; h >= 0; --h) {
      const int mask = (1 << h) - 1;
      for (int j = lane; j < width / 2; j += 32) {
        const int lo = ((j >> h) << (h + 1)) + (j & mask);
        const int hi = h == lg ? lo + (((1 << h) - (j & mask)) << 1) - 1
                               : lo + (1 << h);
        if (hi < length) {
          const int x = a[lo], y = a[hi];
          if (x > y) {
            a[lo] = y;
            a[hi] = x;
          }
        }
      }
      __syncwarp();
    }
  }
}

// Position q's contribution: term[ch] = (v * w) * frac (v * frac without
// weights) and wterm = w * frac, as PR 11's sum kernel and the plain
// version form them.
// vec4: values start on a 16-byte boundary, so with C = 4 a pixel's values
// are one float4 load.
template <int C, bool SNAP, bool HAS_W>
__device__ __forceinline__ void contribution(
    int q, const float* __restrict__ values, const float2* __restrict__ coords,
    const float* __restrict__ weights, int np, bool vec4, float (&term)[C],
    float& wterm) {
  const int k = q >= 2 * np ? (q >= 3 * np ? 3 : 2) : (q >= np ? 1 : 0);
  const int i = q - k * np;
  float x0, y0, fx, fy;
  fractions<SNAP>(coords[i], x0, y0, fx, fy);
  const float frac = corner_fraction(k, fx, fy);
  const float w = HAS_W ? weights[i] : 1.0f;
  float v[C];
  if constexpr (C == 4) {
    if (vec4) {
      const float4 v4 = reinterpret_cast<const float4*>(values)[i];
      v[0] = v4.x;
      v[1] = v4.y;
      v[2] = v4.z;
      v[3] = v4.w;
    }
  }
  if (C != 4 || !vec4) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) v[ch] = values[static_cast<int64_t>(i) * C + ch];
  }
#pragma unroll
  for (int ch = 0; ch < C; ++ch) {
    const float vw = HAS_W ? __fmul_rn(v[ch], w) : v[ch];
    term[ch] = __fmul_rn(vw, frac);
  }
  wterm = HAS_W ? __fmul_rn(w, frac) : 0.0f;
}

template <int C, bool HAS_W>
__device__ __forceinline__ void store(float* __restrict__ accum,
                                      float* __restrict__ wsum, int t,
                                      const float (&acc)[C], float ws) {
  const int64_t out = static_cast<int64_t>(t) * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) accum[out + ch] = flushed(acc[ch]);
  if (HAS_W) wsum[t] = flushed(ws);
}

template <int C, bool SNAP, bool HAS_W>
__global__ void __launch_bounds__(kThreads)
    splat_sort_sum_kernel(const float* __restrict__ values,
                          const float2* __restrict__ coords,
                          const float* __restrict__ weights,
                          const int* __restrict__ cursor,
                          const int* __restrict__ pos,
                          int* __restrict__ long_list,
                          int* __restrict__ long_count,
                          float* __restrict__ accum, float* __restrict__ wsum,
                          int np, int targets, bool vec4) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int start = 0, length = 0;
  if (t < targets) {
    start = t > 0 ? cursor[t - 1] : 0;
    length = cursor[t] - start;
  }
  // Runs longer than kShortRun go to the warp path, listed in any order:
  // each target's sum is its own.
  const bool is_long = length > kShortRun;
  const unsigned longs = __ballot_sync(kFull, is_long);
  if (longs) {
    int first = 0;
    if (lane == __ffs(longs) - 1) first = atomicAdd(long_count, __popc(longs));
    first = __shfl_sync(kFull, first, __ffs(longs) - 1);
    if (is_long) long_list[first + __popc(longs & ((1u << lane) - 1))] = t;
  }
  const int n = is_long ? 0 : length;
  const int widest = __reduce_max_sync(kFull, n);
  if (t >= targets || is_long) return;
  int p[kShortRun];
#pragma unroll
  for (int j = 0; j < kShortRun; ++j) p[j] = j < n ? pos[start + j] : INT_MAX;
  if (widest <= 8) {
    sort_registers<8>(p);
  } else if (widest <= 16) {
    sort_registers<16>(p);
  } else {
    sort_registers<kShortRun>(p);
  }
  float acc[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
  float ws = 0.0f;
#pragma unroll
  for (int j = 0; j < kShortRun; ++j) {
    if (j >= n) break;
    float term[C], wterm;
    contribution<C, SNAP, HAS_W>(p[j], values, coords, weights, np, vec4,
                                 term, wterm);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc[ch] = __fadd_rn(acc[ch], term[ch]);
    if (HAS_W) ws = __fadd_rn(ws, wterm);
  }
  store<C, HAS_W>(accum, wsum, t, acc, ws);
}

template <int C, bool SNAP, bool HAS_W>
__global__ void __launch_bounds__(kThreads)
    splat_sort_long_kernel(const float* __restrict__ values,
                           const float2* __restrict__ coords,
                           const float* __restrict__ weights,
                           const int* __restrict__ cursor,
                           int* __restrict__ pos,
                           const int* __restrict__ long_list,
                           const int* __restrict__ long_count,
                           float* __restrict__ accum,
                           float* __restrict__ wsum, int np, bool vec4) {
  __shared__ int runs[kWarps][kLongRun];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int listed = *long_count;
  for (int j = blockIdx.x * kWarps + warp; j < listed;
       j += gridDim.x * kWarps) {
    const int t = long_list[j];
    const int start = t > 0 ? cursor[t - 1] : 0;
    const int length = cursor[t] - start;
    volatile int* run = pos + start;
    if (length <= kLongRun) {
      for (int m = lane; m < length; m += 32) runs[warp][m] = pos[start + m];
      run = runs[warp];
    }
    __syncwarp();
    sort_warp(run, length, lane);
    float acc[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
    float ws = 0.0f;
    for (int b = 0; b < length; b += 32) {
      const int m = min(32, length - b);
      float term[C], wterm = 0.0f;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) term[ch] = 0.0f;
      if (lane < m) {
        contribution<C, SNAP, HAS_W>(run[b + lane], values, coords, weights,
                                     np, vec4, term, wterm);
      }
      // Every lane adds the chunk's terms in rank order: lane s holds the
      // term of rank b + s.
      for (int s = 0; s < m; ++s) {
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          acc[ch] = __fadd_rn(acc[ch], __shfl_sync(kFull, term[ch], s));
        }
        if (HAS_W) ws = __fadd_rn(ws, __shfl_sync(kFull, wterm, s));
      }
    }
    if (lane == 0) store<C, HAS_W>(accum, wsum, t, acc, ws);
    __syncwarp();  // the run's buffer is reused by the warp's next target
  }
}

int blocks(int64_t threads) {
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

template <int C, bool SNAP, bool HAS_W>
cudaError_t launch_sums(const float* v, const float2* c, const float* w,
                        const int* cursor, int* pos, int* long_list,
                        int* long_count, float* a, float* s, int np,
                        int targets, int long_blocks, cudaStream_t st) {
  const bool vec4 = reinterpret_cast<uintptr_t>(v) % 16 == 0;
  splat_sort_sum_kernel<C, SNAP, HAS_W><<<blocks(targets), kThreads, 0,
                                          st>>>(v, c, w, cursor, pos,
                                                long_list, long_count, a, s,
                                                np, targets, vec4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || long_blocks == 0) return err;
  splat_sort_long_kernel<C, SNAP, HAS_W><<<long_blocks, kThreads, 0, st>>>(
      v, c, w, cursor, pos, long_list, long_count, a, s, np, vec4);
  return cudaGetLastError();
}

template <int C, bool SNAP>
cudaError_t launch_sums(const float* v, const float2* c, const float* w,
                        const int* cursor, int* pos, int* long_list,
                        int* long_count, float* a, float* s, int np,
                        int targets, int long_blocks, cudaStream_t st) {
  return w != nullptr
             ? launch_sums<C, SNAP, true>(v, c, w, cursor, pos, long_list,
                                          long_count, a, s, np, targets,
                                          long_blocks, st)
             : launch_sums<C, SNAP, false>(v, c, w, cursor, pos, long_list,
                                           long_count, a, s, np, targets,
                                           long_blocks, st);
}

// The sizes the entry point checks: positions and targets must fit int32,
// the grid CUDA's x limit.
bool sizes_fit(int64_t n, int64_t src_h, int64_t src_w, int64_t out_h,
               int64_t out_w) {
  const int64_t np = n * src_h * src_w;
  const int64_t targets = n * out_h * out_w;
  return n > 0 && src_h > 0 && src_w > 0 && out_h > 0 && out_w > 0 &&
         4 * np < (int64_t{1} << 31) && targets < INT_MAX;
}

}  // namespace

// values (n, src_h, src_w, channels), coords (.., 2), weights (.., 1) or
// null -> accum (n, out_h, out_w, channels) and wsum (.., 1) (null with
// null weights), every pixel written. snap: snap the fractions. max_dy >=
// 0: the windowed splat, base row r % fold_h + base_offset (src_h a
// multiple of fold_h, base rows inside the target); max_dy < 0:
// unwindowed, fold_h and base_offset unused.
//
// scratch: int32, targets + 1 + tiles + 4 * np + long_capacity of them
// (targets = n * out_h * out_w, tiles = ceil(targets / kScanTile)): the
// cursors (one a target, then the long-run count), the tile sums, the
// positions and the list of long runs. long_capacity: at most
// 4 np / (kShortRun + 1) runs can be long (and at most targets);
// long_blocks: the long-run kernel's grid (0 when long_capacity is 0).
extern "C" int lsi_splat_sort(const void* values, const void* coords,
                              const void* weights, void* accum, void* wsum,
                              void* scratch, int64_t n, int64_t src_h,
                              int64_t src_w, int channels, int64_t out_h,
                              int64_t out_w, int snap, int max_dy,
                              int64_t fold_h, int64_t base_offset,
                              int64_t long_capacity, int long_blocks,
                              void* stream) {
  if (!sizes_fit(n, src_h, src_w, out_h, out_w) ||
      (weights == nullptr) != (wsum == nullptr) || scratch == nullptr ||
      long_capacity < 0 || long_blocks < 0 ||
      (long_capacity > 0) != (long_blocks > 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (max_dy >= 0 && (fold_h <= 0 || src_h % fold_h != 0 ||
                      base_offset < 0 || base_offset + fold_h > out_h)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t np = n * src_h * src_w;
  const int targets = static_cast<int>(n * out_h * out_w);
  const int tiles = (targets + kScanTile - 1) / kScanTile;
  // Every run longer than kShortRun must find a place in the list.
  const int64_t most_long = 4 * np / (kShortRun + 1);
  if (long_capacity < (most_long < targets ? most_long : targets)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{np,
                   static_cast<int>(src_h),
                   static_cast<int>(src_w),
                   static_cast<int>(out_h),
                   static_cast<int>(out_w),
                   max_dy,
                   max_dy >= 0 ? static_cast<int>(fold_h) : 1,
                   max_dy >= 0 ? static_cast<int>(base_offset) : 0};
  const auto* v = static_cast<const float*>(values);
  const auto* c = static_cast<const float2*>(coords);
  const auto* w = static_cast<const float*>(weights);
  auto* a = static_cast<float*>(accum);
  auto* s = static_cast<float*>(wsum);
  int* cursor = static_cast<int*>(scratch);
  int* long_count = cursor + targets;
  int* tile_sums = long_count + 1;
  int* pos = tile_sums + tiles;
  int* long_list = pos + 4 * np;
  auto st = static_cast<cudaStream_t>(stream);

  cudaError_t err = cudaMemsetAsync(
      cursor, 0, (static_cast<size_t>(targets) + 1) * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (snap) {
    splat_sort_count_kernel<true><<<blocks(np), kThreads, 0, st>>>(
        c, cursor, g);
  } else {
    splat_sort_count_kernel<false><<<blocks(np), kThreads, 0, st>>>(
        c, cursor, g);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  splat_sort_scan_reduce_kernel<<<tiles, kThreads, 0, st>>>(
      cursor, tile_sums, targets);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  splat_sort_scan_tiles_kernel<<<1, kThreads, 0, st>>>(tile_sums, tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  splat_sort_scan_apply_kernel<<<tiles, kThreads, 0, st>>>(
      cursor, tile_sums, targets);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (snap) {
    splat_sort_fill_kernel<true><<<blocks(np), kThreads, 0, st>>>(
        c, cursor, pos, g);
  } else {
    splat_sort_fill_kernel<false><<<blocks(np), kThreads, 0, st>>>(
        c, cursor, pos, g);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int npi = static_cast<int>(np);
  switch (channels) {
#define LSI_SORT_CASE(CH)                                                 \
  case CH:                                                                \
    err = snap ? launch_sums<CH, true>(v, c, w, cursor, pos, long_list,   \
                                       long_count, a, s, npi, targets,    \
                                       long_blocks, st)                   \
               : launch_sums<CH, false>(v, c, w, cursor, pos, long_list,  \
                                        long_count, a, s, npi, targets,   \
                                        long_blocks, st);                 \
    break;
    LSI_SORT_CASE(1)
    LSI_SORT_CASE(2)
    LSI_SORT_CASE(3)
    LSI_SORT_CASE(4)
    LSI_SORT_CASE(5)
    LSI_SORT_CASE(6)
    LSI_SORT_CASE(7)
    LSI_SORT_CASE(8)
#undef LSI_SORT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
