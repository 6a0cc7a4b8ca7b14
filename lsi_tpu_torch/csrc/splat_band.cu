// Windowed forward bilinear splat (scatter-add) for Hopper (sm_90a): the
// band kernel.
//
// Replaces the TPU kernel lsi_tpu/kernels/splat_pallas.py:_splat_kernel in
// its windowed contract (max_dy >= 0, the folded rows of _fold_coords):
// a corner of source row r is dropped when its target row yi has yi - base
// outside [-max_dy, max_dy + 1], base = r % fold_h + base_offset. It
// computes exactly lsi_tpu/ops/splat.py:splat_bilinear with
// max_dy_window and base_rows (the plain version beside this kernel is
// lsi_tpu_torch/ops/splat.py): the same snap, the corner tests made in
// float before any float->int conversion (projected coordinates reach
// +-1e6, inf and nan, which fail every test and are dropped), and
// denormal sums flushed to zero as the box kernel's global atomics flush
// them (H12: a shared-memory float atomic keeps them).
//
// What bounds it on an H100: bytes. Each input read once and accum (and
// wsum) written once: on the route MPI step's planes' gradient ((128, 128,
// 256, 4) -> (128, 256), window 2, no weights) 167.8 MB, 50.1 us at 3.35
// TB/s; on the route's b8 serving render ((8, 512, 768, 4) -> (256, 768),
// window 2) 119.5 MB, 35.7 us.
//
// Design. The TPU kernel keeps one output tile resident across a
// sequential grid and adds each source row into its 2 max_dy + 2 window
// rows. Here blocks run in parallel, so a block owns rows instead: one
// block per band of `band_rows` target rows of one image, at full width
// (blockIdx.x the band, .y the image). The window tells which source rows
// can reach a band before any coordinate is read: in each folded layer l
// the rows l fold_h + b with b in [t0 - max_dy - 1 - base_offset,
// t0 + rows - 1 + max_dy - base_offset], clipped to [0, fold_h). The block
// zeroes its band in shared memory (C planes, and one of wsum when there
// are weights, channel-major: neighbouring targets in neighbouring banks;
// the planes `plane_stride` floats apart, padded so that the store's
// pixel-major reads spread over the banks), reads the coordinates of
// those rows only, adds the corners that land in its own rows with
// shared-memory atomics and drops the others (they belong to another
// band), and reads a pixel's values and weight only where a corner lands.
// Then it writes the band to accum and wsum with plain coalesced stores,
// zeros included: no global atomics, no pass to find a bounding box, and
// no torch.zeros before the launch. A warp's task is kTaskW columns of
// one visited row: the row's layer and base row are found once a task,
// each lane loads its kUnroll coordinates together, and a coordinate
// whose corner rows miss the band is culled after one floor and two
// compares (most of a window's edge rows). 512 threads a block, at most
// 32 registers each, so that 4 blocks share an SM; the wrapper's plan
// (lsi_tpu_torch/kernels/splat_cuda.py:band_tiling) chooses the band
// height within a quarter of the SM's shared memory and passes it and the
// plane stride in.
//
// What holds it back, measured on the card (PERF.md §6;
// scripts/compare_parent_kernels.py): a float atomicAdd to shared memory
// is a compare-and-swap loop in SASS (ATOMS.CAST.SPIN), and on a render's
// splat about a fifth of a warp's corners aim at a pixel another lane's
// same corner aims at, so those loops retry; the atomics take most of
// the kernel's time there. And a band re-reads the coordinates of every
// visited row: rows + 2 max_dy + 1 rows a layer for its rows. Where that
// is more than 4 rows a band row (a wide window) or the plan has fewer
// blocks than the card has slots for, the box kernel stays the faster,
// and the wrapper keeps it (splat_cuda.use_band). Streaming the
// coordinates through a ring in shared memory with cp.async.bulk, packing
// the live pixels into whole warps, summing a warp's same-pixel corners
// by shuffles before one atomic, and merging a column's corners down its
// rows were each tried and were slower on the route step's inputs.
//
// Tensor cores do not serve this: the TPU ran per-row tent matrices
// through its matrix unit because it has no scatter, but a tent matrix row
// has 2 non-zeros, so a dense product does (2 max_dy + 2) out_w / 4 times
// the useful work (~3,500x at window 8 and out_w 768).
//
// Without weights (null weights and wsum: the gather's image gradient) a
// pixel's payload is its values, and the band holds C planes.
//
// Plain C interface (loaded with ctypes): launches on the calling
// thread's current device and returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kMinFraction = 1e-4f;  // ops/splat.py MIN_FRACTION
constexpr int kThreads = 512;          // threads per block
constexpr int kBlocksPerSM = 4;        // caps registers at 32 a thread
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;             // coordinates a lane loads at once
constexpr int kTaskW = 32 * kUnroll;   // columns of a warp's task

__device__ __forceinline__ float snap_fraction(float f) {
  if (f < kMinFraction) return 0.0f;
  if (f > 1.0f - kMinFraction) return 1.0f;
  return f;
}

// What a float atomicAdd of x into a zeroed global element stores (PTX
// atom.add.f32: round to nearest, subnormal inputs and results flushed to
// zero): the box kernel's flush of a pixel's sum.
__device__ __forceinline__ float flushed(float x) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(x));
  return r;
}

// The block's geometry: its band and the source rows it visits.
struct Band {
  int t0, rows;    // target rows [t0, t0 + rows)
  int b_lo, nb;    // visited rows b_lo .. b_lo + nb - 1 of every layer
  int layers;
};

__device__ __forceinline__ Band band_of_block(int band_rows, int out_h,
                                              int max_dy, int fold_h,
                                              int base_offset, int src_h) {
  Band b;
  b.t0 = blockIdx.x * band_rows;
  b.rows = min(band_rows, out_h - b.t0);
  b.b_lo = max(0, b.t0 - max_dy - 1 - base_offset);
  const int b_hi = min(fold_h - 1, b.t0 + b.rows - 1 + max_dy - base_offset);
  b.nb = max(0, b_hi - b.b_lo + 1);
  b.layers = src_h / fold_h;
  return b;
}

// One visited row: its source row and the band rows [lo, hi] its window
// reaches (small integers, so exact in float).
struct Row {
  int r;
  float lo, hi;
};

__device__ __forceinline__ Row visited_row(const Band& b, int i, int fold_h,
                                           int base_offset, int max_dy) {
  const int l = i / b.nb;
  const int bb = b.b_lo + i - l * b.nb;
  const int base = bb + base_offset;
  Row row;
  row.r = l * fold_h + bb;
  row.lo = static_cast<float>(max(b.t0, base - max_dy));
  row.hi = static_cast<float>(min(b.t0 + b.rows - 1, base + max_dy + 1));
  return row;
}

// The corners of a coordinate q in the band's rows [row.lo, row.hi]:
// corner k (00, 01, 10, 11) is live when its fraction is > 0, its column
// lies in the target and its row in [lo, hi]. Tested in float, so NaN and
// +-1e6 fail; a coordinate whose corner rows miss [lo, hi] is culled after
// one floor and two compares; converted to int only when live.
struct PixelCorners {
  int x, y;  // corner 00's column and band row
  float frac[4];
  int live;  // bit k: corner k
};

template <bool SNAP>
__device__ __forceinline__ PixelCorners band_corners(float2 q, const Row& row,
                                                     int t0, int out_w) {
  PixelCorners c;
  c.live = 0;
  c.x = c.y = 0;
  const float y0 = floorf(q.y);
  if (!(y0 >= row.lo - 1.0f && y0 <= row.hi)) return c;  // culls NaN too
  const float x0 = floorf(q.x);
  const float fx = SNAP ? snap_fraction(q.x - x0) : q.x - x0;
  const float fy = SNAP ? snap_fraction(q.y - y0) : q.y - y0;
  c.frac[0] = (1.0f - fx) * (1.0f - fy);
  c.frac[1] = fx * (1.0f - fy);
  c.frac[2] = (1.0f - fx) * fy;
  c.frac[3] = fx * fy;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float xf = x0 + (k & 1);
    const float yf = y0 + (k >> 1);
    c.live |= (c.frac[k] > 0.0f && xf >= 0.0f &&
               xf <= static_cast<float>(out_w - 1) && yf >= row.lo &&
               yf <= row.hi) << k;
  }
  if (c.live) {
    c.x = static_cast<int>(x0);
    c.y = static_cast<int>(y0) - t0;
  }
  return c;
}

// Pixel i's weight (1 without weights) and its values times it.
template <int C, bool HAS_W>
__device__ __forceinline__ float load_payload(
    const float* __restrict__ values, const float* __restrict__ weights,
    int64_t i, int vec4, float (&pay)[C]) {
  const float w = HAS_W ? weights[i] : 1.0f;
  if constexpr (C == 4) {
    if (vec4) {
      const float4 v = reinterpret_cast<const float4*>(values)[i];
      pay[0] = v.x * w;
      pay[1] = v.y * w;
      pay[2] = v.z * w;
      pay[3] = v.w * w;
      return w;
    }
  }
#pragma unroll
  for (int ch = 0; ch < C; ++ch) pay[ch] = values[i * C + ch] * w;
  return w;
}

template <int C, bool SNAP, bool HAS_W>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    splat_band_kernel(const float* __restrict__ values,
                      const float* __restrict__ coords,
                      const float* __restrict__ weights,
                      float* __restrict__ accum, float* __restrict__ wsum,
                      int src_h, int src_w, int out_h, int out_w,
                      int band_rows, int max_dy, int fold_h,
                      int base_offset, int plane_stride, int vec4) {
  extern __shared__ __align__(16) float band[];
  constexpr int P = C + (HAS_W ? 1 : 0);
  const Band b = band_of_block(band_rows, out_h, max_dy, fold_h,
                               base_offset, src_h);
  const int band_px = b.rows * out_w;
  const int64_t src_base = static_cast<int64_t>(blockIdx.y) * src_h * src_w;
  const float2* xy = reinterpret_cast<const float2*>(coords) + src_base;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  {
    float4* band4 = reinterpret_cast<float4*>(band);
    const int n4 = P * plane_stride / 4;
    for (int k = threadIdx.x; k < n4; k += kThreads) {
      band4[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    for (int k = 4 * n4 + threadIdx.x; k < P * plane_stride; k += kThreads) {
      band[k] = 0.0f;
    }
  }
  __syncthreads();

  // Tasks: kTaskW columns of one visited row.
  const int row_tasks = (src_w + kTaskW - 1) / kTaskW;
  const int tasks = b.layers * b.nb * row_tasks;
  const float nan = __int_as_float(0x7fc00000);
  for (int task = warp; task < tasks; task += kWarps) {
    const int i = task / row_tasks;
    const int col0 = (task - i * row_tasks) * kTaskW + lane;
    const Row row = visited_row(b, i, fold_h, base_offset, max_dy);
    const int p0 = row.r * src_w + col0;
    float2 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      q[u] = col0 + 32 * u < src_w ? xy[p0 + 32 * u] : make_float2(nan, nan);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const PixelCorners c = band_corners<SNAP>(q[u], row, b.t0, out_w);
      if (!c.live) continue;
      float pay[C];
      const float w = load_payload<C, HAS_W>(values, weights,
                                             src_base + p0 + 32 * u, vec4,
                                             pay);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!(c.live >> k & 1)) continue;
        const float f = c.frac[k];
        const int t = (c.y + (k >> 1)) * out_w + c.x + (k & 1);
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          atomicAdd(&band[ch * plane_stride + t], pay[ch] * f);
        }
        if (HAS_W) atomicAdd(&band[C * plane_stride + t], w * f);
      }
    }
  }
  __syncthreads();

  // The band, zeros included, to accum (pixel-major, NHWC) and wsum.
  const int64_t out0 =
      (static_cast<int64_t>(blockIdx.y) * out_h + b.t0) * out_w;
  if constexpr (C == 4) {
    float4* acc = reinterpret_cast<float4*>(accum) + out0;
    for (int k = threadIdx.x; k < band_px; k += kThreads) {
      acc[k] = make_float4(flushed(band[k]), flushed(band[plane_stride + k]),
                           flushed(band[2 * plane_stride + k]),
                           flushed(band[3 * plane_stride + k]));
    }
  } else {
    float* acc = accum + out0 * C;
    for (int k = threadIdx.x; k < band_px * C; k += kThreads) {
      const int px = k / C;
      acc[k] = flushed(band[(k - px * C) * plane_stride + px]);
    }
  }
  if (HAS_W) {
    for (int k = threadIdx.x; k < band_px; k += kThreads) {
      wsum[out0 + k] = flushed(band[C * plane_stride + k]);
    }
  }
}

template <int C, bool SNAP, bool HAS_W>
cudaError_t launch(const float* values, const float* coords,
                   const float* weights, float* accum, float* wsum,
                   int64_t n, int64_t src_h, int64_t src_w, int64_t out_h,
                   int64_t out_w, int band_rows, int max_dy, int fold_h,
                   int base_offset, int plane_stride, int smem_bytes,
                   int vec4, cudaStream_t stream) {
  auto kernel = splat_band_kernel<C, SNAP, HAS_W>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((out_h + band_rows - 1) / band_rows, n);
  kernel<<<grid, kThreads, smem_bytes, stream>>>(
      values, coords, weights, accum, wsum, static_cast<int>(src_h),
      static_cast<int>(src_w), static_cast<int>(out_h),
      static_cast<int>(out_w), band_rows, max_dy, fold_h, base_offset,
      plane_stride, vec4);
  return cudaGetLastError();
}

template <int C, bool SNAP>
cudaError_t launch_w(bool has_w, const float* v, const float* c,
                     const float* w, float* a, float* s, int64_t n,
                     int64_t src_h, int64_t src_w, int64_t out_h,
                     int64_t out_w, int band_rows, int max_dy, int fold_h,
                     int base_offset, int plane_stride, int smem_bytes,
                     int vec4, cudaStream_t st) {
  return has_w ? launch<C, SNAP, true>(v, c, w, a, s, n, src_h, src_w, out_h,
                                       out_w, band_rows, max_dy, fold_h,
                                       base_offset, plane_stride, smem_bytes,
                                       vec4, st)
               : launch<C, SNAP, false>(v, c, w, a, s, n, src_h, src_w,
                                        out_h, out_w, band_rows, max_dy,
                                        fold_h, base_offset, plane_stride,
                                        smem_bytes, vec4, st);
}

}  // namespace

// values (n, src_h, src_w, channels), coords (.., 2), weights (.., 1) ->
// accum (n, out_h, out_w, channels) and wsum (.., 1), every element
// written (the caller need not zero them; accum 16-byte aligned at
// channels 4). weights and wsum are both null or both given. The window:
// max_dy >= 0, base row r % fold_h + base_offset (src_h a multiple of
// fold_h, base rows inside the target). The plan (splat_cuda.band_tiling):
// band_rows target rows a block; the band's planes plane_stride floats
// apart (>= band_rows * out_w); smem_bytes of dynamic shared memory; vec4:
// float4 value loads (channels 4, values 16-byte aligned).
extern "C" int lsi_splat_band(const void* values, const void* coords,
                              const void* weights, void* accum, void* wsum,
                              int64_t n, int64_t src_h, int64_t src_w,
                              int channels, int64_t out_h, int64_t out_w,
                              int snap, int max_dy, int64_t fold_h,
                              int64_t base_offset, int band_rows,
                              int plane_stride, int smem_bytes, int vec4,
                              void* stream) {
  if (n * out_h * out_w == 0) return 0;
  const bool has_w = weights != nullptr;
  if ((wsum != nullptr) != has_w || max_dy < 0 || fold_h <= 0 ||
      src_h % fold_h != 0 || base_offset < 0 ||
      base_offset + fold_h > out_h || band_rows <= 0 ||
      plane_stride < band_rows * out_w ||
      (channels == 4 && reinterpret_cast<uintptr_t>(accum) % 16 != 0) ||
      (vec4 && channels != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* v = static_cast<const float*>(values);
  const auto* c = static_cast<const float*>(coords);
  const auto* w = static_cast<const float*>(weights);
  auto* a = static_cast<float*>(accum);
  auto* s = static_cast<float*>(wsum);
  auto st = static_cast<cudaStream_t>(stream);
  const int fd = static_cast<int>(fold_h);
  const int bo = static_cast<int>(base_offset);
  cudaError_t err = cudaSuccess;
  switch (channels) {
#define LSI_BAND_CASE(CH)                                                    \
  case CH:                                                                   \
    err = snap ? launch_w<CH, true>(has_w, v, c, w, a, s, n, src_h, src_w,   \
                                    out_h, out_w, band_rows, max_dy, fd, bo, \
                                    plane_stride, smem_bytes, vec4, st)      \
               : launch_w<CH, false>(has_w, v, c, w, a, s, n, src_h, src_w,  \
                                     out_h, out_w, band_rows, max_dy, fd,    \
                                     bo, plane_stride, smem_bytes, vec4,     \
                                     st);                                    \
    break;
    LSI_BAND_CASE(1)
    LSI_BAND_CASE(2)
    LSI_BAND_CASE(3)
    LSI_BAND_CASE(4)
    LSI_BAND_CASE(5)
    LSI_BAND_CASE(6)
    LSI_BAND_CASE(7)
    LSI_BAND_CASE(8)
#undef LSI_BAND_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
