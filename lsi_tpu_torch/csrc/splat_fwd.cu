// Forward bilinear splat (scatter-add) for Hopper (sm_90a): the box kernel.
//
// Replaces the TPU kernel lsi_tpu/kernels/splat_pallas.py:_splat_kernel
// (launched by splat_pallas). The TPU version builds per-row tent matrices
// and runs them through the matrix unit inside a static vertical window;
// here every source pixel scatters to its four target corners with
// float32 atomics, which gives the exact semantics of
// lsi_tpu/ops/splat.py:splat_bilinear, unwindowed or with its vertical
// window (the plain version beside this kernel is
// lsi_tpu_torch/ops/splat.py).
//
// What bounds it on an H100: atomics, not bytes. At the render's shape
// (N=8, Hs=L*H=512, Ws=768, C=4) the bytes alone (~88 MB read, ~31 MB of
// accumulators) take ~36 us, but a scatter of C+1 scalar atomics to global
// memory per in-image corner (up to 20 per source pixel, ~63 M per call)
// took 0.3-0.7 ms, growing with the atomics issued (PERF.md).
//
// Design: one CTA per tile of source pixels inside one image (blockIdx.x
// the column tile, .y the row tile, .z the image; offsets inside an image
// are 32-bit, the image base int64). The block first reduces the bounding
// box of its in-image target corners. A render's tile lands on a compact
// patch of the target (neighbouring source pixels project to neighbouring
// targets), so when box x (C+1) floats fit the dynamic shared memory the
// wrapper chose, the block accumulates there with shared-memory atomics,
// channel-major so that neighbouring targets sit in neighbouring banks,
// and then flushes the box to global memory with one vector atomic per
// non-zero target pixel (atomicAdd on a float4, global memory, sm_90, for
// accum at C=4, and one scalar atomic for wsum). When the box does not
// fit (scattered or far targets) the block scatters straight to global
// memory with the same vector atomics: 2 per corner at C=4 instead of 5.
// The tile shape, the shared-memory budget and the vector path (C=4, all
// pointers 16-byte aligned) are chosen by the wrapper
// (lsi_tpu_torch/kernels/splat_cuda.py:splat_tiling) and passed in. Both
// paths beat that plain per-pixel scatter by 2.7-3.2x on the main path's
// own inputs; the budget trades the shared path's reach against blocks
// per SM (PERF.md). The wrapper's two torch.zeros (~27-30 us) stay.
//
// SNAP (the render) snaps the fractions as ops/splat.py does; without it
// the kernel is the exact transpose of the unsnapped bilinear gather (the
// gather's image gradient). HAS_W false (null weights and wsum: the
// gather's image gradient) scatters the values themselves, with no wsum
// plane in the box and no wsum atomics; a template parameter, so the
// weighted kernels compile as before.
//
// The windowed mode (max_dy >= 0) is the TPU kernel's contract, which the
// height-sharded render (lsi_tpu_torch/parallel/spatial.py) relies on: a
// corner is dropped when its target row yi has yi - base outside
// [-max_dy, max_dy + 1], base = r % fold_h + base_offset for source row r
// of the image (lsi_tpu/kernels/splat_pallas.py:_fold_coords; the plain
// version is ops/splat.py's max_dy_window). The test is one more
// predicate on a corner's liveness, so a dropped corner leaves the
// block's bounding box too and both paths (shared memory and global
// atomics) drop it alike. max_dy < 0 is the unwindowed splat. A
// windowed splat whose bands re-read few rows takes the band kernel
// instead (csrc/splat_band.cu; kernels/splat_cuda.py:use_band gives the
// rule and the measurements behind it).
//
// Summation order is not fixed (atomics), so
// results differ from run to run in the last bits (H8). Bounds are tested
// in float BEFORE any float->int conversion: projected coordinates reach
// +-1e6 where the projection clamps its denominator, and an out-of-range
// float->int cast is undefined; a non-finite coordinate fails every test
// and is dropped.
//
// Plain C interface (loaded with ctypes): launches on the calling
// thread's current device (the wrapper selects the tensors' device) and
// returns cudaGetLastError() after the launch, 0 on success.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kMinFraction = 1e-4f;  // ops/splat.py MIN_FRACTION
constexpr int kThreads = 256;          // threads per block, any 2D shape

__device__ __forceinline__ float snap_fraction(float f) {
  if (f < kMinFraction) return 0.0f;
  if (f > 1.0f - kMinFraction) return 1.0f;
  return f;
}

// The in-image corners of one coordinate: corner k (00, 01, 10, 11) is
// live when its fraction is > 0, it lies in the out_h x out_w target and,
// when max_dy >= 0, its row lies in [base - max_dy, base + max_dy + 1].
struct Corners {
  int xi, yi;     // corner 00, valid only for live corners' arithmetic
  float frac[4];
  bool live[4];
};

template <bool SNAP>
__device__ __forceinline__ Corners corners(float x, float y, int out_h,
                                           int out_w, int base, int max_dy) {
  Corners c;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = SNAP ? snap_fraction(x - x0) : x - x0;
  const float fy = SNAP ? snap_fraction(y - y0) : y - y0;
  c.frac[0] = (1.0f - fx) * (1.0f - fy);
  c.frac[1] = fx * (1.0f - fy);
  c.frac[2] = (1.0f - fx) * fy;
  c.frac[3] = fx * fy;
  bool any = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float xf = x0 + (k & 1);
    const float yf = y0 + (k >> 1);
    // NaN coordinates fail every comparison and are dropped too.
    c.live[k] = c.frac[k] > 0.0f && xf >= 0.0f &&
                xf <= static_cast<float>(out_w - 1) && yf >= 0.0f &&
                yf <= static_cast<float>(out_h - 1);
    // Exact in float: it decides only for rows inside the target.
    if (max_dy >= 0) {
      const float ky = yf - static_cast<float>(base);
      c.live[k] = c.live[k] && ky >= static_cast<float>(-max_dy) &&
                  ky <= static_cast<float>(max_dy + 1);
    }
    any |= c.live[k];
  }
  // Converted only where some corner is in the image: then x0 and y0 lie
  // within one pixel of it.
  c.xi = any ? static_cast<int>(x0) : 0;
  c.yi = any ? static_cast<int>(y0) : 0;
  return c;
}

// out = the C floats of pixel i of src, times scale; one float4 load when
// C = 4 and vec4 (src 16-byte aligned).
template <int C>
__device__ __forceinline__ void load_scaled(const float* src, int64_t i,
                                            float scale, int vec4,
                                            float out[C]) {
  if constexpr (C == 4) {
    if (vec4) {
      const float4 v = reinterpret_cast<const float4*>(src)[i];
      out[0] = v.x * scale;
      out[1] = v.y * scale;
      out[2] = v.z * scale;
      out[3] = v.w * scale;
      return;
    }
  }
#pragma unroll
  for (int ch = 0; ch < C; ++ch) out[ch] = src[i * C + ch] * scale;
}

// Global atomics for target pixel t: accum[t] += add and, with HAS_W,
// wsum[t] += w. One vector atomic for accum when C = 4 and vec4.
template <int C, bool HAS_W>
__device__ __forceinline__ void add_pixel(float* accum, float* wsum,
                                          int64_t t, const float add[C],
                                          float w, int vec4) {
  bool done = false;
  if constexpr (C == 4) {
    if (vec4) {
      atomicAdd(reinterpret_cast<float4*>(accum) + t,
                make_float4(add[0], add[1], add[2], add[3]));
      done = true;
    }
  }
  if (!done) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) atomicAdd(&accum[t * C + ch], add[ch]);
  }
  if (HAS_W) atomicAdd(&wsum[t], w);
}

template <int C, bool SNAP, bool HAS_W>
__global__ void __launch_bounds__(kThreads)
    splat_fwd_kernel(const float* __restrict__ values,
                     const float* __restrict__ coords,
                     const float* __restrict__ weights,
                     float* __restrict__ accum, float* __restrict__ wsum,
                     int src_h, int src_w, int out_h, int out_w, int tile_h,
                     int smem_floats, int vec4, int max_dy, int fold_h,
                     int base_offset) {
  // The box: C planes of accum and, with HAS_W, 1 of wsum.
  constexpr int P = C + (HAS_W ? 1 : 0);
  extern __shared__ float smem[];
  __shared__ int box[4];  // min x, max x, min y, max y of live corners

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row0 = blockIdx.y * tile_h;
  const int row_end = min(row0 + tile_h, src_h);
  const int64_t src_base = static_cast<int64_t>(blockIdx.z) * src_h * src_w;
  const int64_t out_base = static_cast<int64_t>(blockIdx.z) * out_h * out_w;
  const float2* xy = reinterpret_cast<const float2*>(coords) + src_base;

  // Pass 1, when there is shared memory to use: the bounding box of the
  // tile's live corners; a box that fits is zeroed there. The box is
  // planar (channel-major): neighbouring target pixels in neighbouring
  // banks.
  bool in_smem = false;
  int bx0 = 0, by0 = 0, bw = 0, box_px = 0;
  if (smem_floats > 0) {  // block-uniform
    if (tid == 0) {
      box[0] = box[2] = INT_MAX;
      box[1] = box[3] = INT_MIN;
    }
    __syncthreads();
    int lo_x = INT_MAX, hi_x = INT_MIN, lo_y = INT_MAX, hi_y = INT_MIN;
    if (col < src_w) {
      for (int r = row0 + threadIdx.y; r < row_end; r += blockDim.y) {
        const float2 p = xy[r * src_w + col];
        const Corners c = corners<SNAP>(
            p.x, p.y, out_h, out_w,
            max_dy >= 0 ? r % fold_h + base_offset : 0, max_dy);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!c.live[k]) continue;
          lo_x = min(lo_x, c.xi + (k & 1));
          hi_x = max(hi_x, c.xi + (k & 1));
          lo_y = min(lo_y, c.yi + (k >> 1));
          hi_y = max(hi_y, c.yi + (k >> 1));
        }
      }
    }
    lo_x = __reduce_min_sync(0xffffffffu, lo_x);
    hi_x = __reduce_max_sync(0xffffffffu, hi_x);
    lo_y = __reduce_min_sync(0xffffffffu, lo_y);
    hi_y = __reduce_max_sync(0xffffffffu, hi_y);
    if ((tid & 31) == 0 && lo_x <= hi_x) {
      atomicMin(&box[0], lo_x);
      atomicMax(&box[1], hi_x);
      atomicMin(&box[2], lo_y);
      atomicMax(&box[3], hi_y);
    }
    __syncthreads();
    bx0 = box[0];
    by0 = box[2];
    if (bx0 > box[1]) return;  // no live corner in the tile
    bw = box[1] - bx0 + 1;
    // Both sides are at most the target's, whose area times C+1 the
    // wrapper keeps below 2^31.
    box_px = bw * (box[3] - by0 + 1);
    in_smem = box_px * P <= smem_floats;
    if (in_smem) {
      for (int k = tid; k < box_px * P; k += kThreads) smem[k] = 0.0f;
      __syncthreads();
    }
  }

  // Pass 2: scatter [v*w, w] to the live corners.
  if (col < src_w) {
    for (int r = row0 + threadIdx.y; r < row_end; r += blockDim.y) {
      const int p = r * src_w + col;
      const float2 q = xy[p];
      const Corners c = corners<SNAP>(
          q.x, q.y, out_h, out_w,
          max_dy >= 0 ? r % fold_h + base_offset : 0, max_dy);
      if (!(c.live[0] || c.live[1] || c.live[2] || c.live[3])) continue;
      const float w = HAS_W ? weights[src_base + p] : 1.0f;
      float pay[C];
      load_scaled<C>(values, src_base + p, w, vec4, pay);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!c.live[k]) continue;
        const int xi = c.xi + (k & 1);
        const int yi = c.yi + (k >> 1);
        const float f = c.frac[k];
        if (in_smem) {
          const int t = (yi - by0) * bw + (xi - bx0);
#pragma unroll
          for (int ch = 0; ch < C; ++ch) {
            atomicAdd(&smem[ch * box_px + t], pay[ch] * f);
          }
          if (HAS_W) atomicAdd(&smem[C * box_px + t], w * f);
          continue;
        }
        float add[C];
#pragma unroll
        for (int ch = 0; ch < C; ++ch) add[ch] = pay[ch] * f;
        add_pixel<C, HAS_W>(accum, wsum, out_base + yi * out_w + xi, add,
                            w * f, vec4);
      }
    }
  }
  if (!in_smem) return;  // block-uniform

  // Flush: one vector atomic (C=4) or C scalar ones, and one for wsum, per
  // non-zero target pixel of the box.
  __syncthreads();
  for (int k = tid; k < box_px; k += kThreads) {
    float a[C];
    const float ws = HAS_W ? smem[C * box_px + k] : 0.0f;
    bool nonzero = ws != 0.0f;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      a[ch] = smem[ch * box_px + k];
      nonzero |= a[ch] != 0.0f;
    }
    if (!nonzero) continue;
    add_pixel<C, HAS_W>(accum, wsum,
                        out_base + (by0 + k / bw) * out_w + (bx0 + k % bw),
                        a, ws, vec4);
  }
}

template <int C, bool SNAP, bool HAS_W>
cudaError_t launch(const float* values, const float* coords,
                   const float* weights, float* accum, float* wsum,
                   int64_t n, int64_t src_h, int64_t src_w, int64_t out_h,
                   int64_t out_w, int block_x, int tile_h, int smem_bytes,
                   int vec4, int max_dy, int fold_h, int base_offset,
                   cudaStream_t stream) {
  auto kernel = splat_fwd_kernel<C, SNAP, HAS_W>;
  // Dynamic + static shared memory above 48 KB needs the opt-in.
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 block(block_x, kThreads / block_x);
  const dim3 grid((src_w + block_x - 1) / block_x,
                  (src_h + tile_h - 1) / tile_h, n);
  kernel<<<grid, block, smem_bytes, stream>>>(
      values, coords, weights, accum, wsum, static_cast<int>(src_h),
      static_cast<int>(src_w), static_cast<int>(out_h),
      static_cast<int>(out_w), tile_h, smem_bytes / 4, vec4, max_dy, fold_h,
      base_offset);
  return cudaGetLastError();
}

template <int C, bool SNAP>
cudaError_t launch_w(bool has_w, const float* v, const float* c,
                     const float* w, float* a, float* s, int64_t n,
                     int64_t src_h, int64_t src_w, int64_t out_h,
                     int64_t out_w, int block_x, int tile_h, int smem_bytes,
                     int vec4, int max_dy, int fold_h, int base_offset,
                     cudaStream_t st) {
  return has_w ? launch<C, SNAP, true>(v, c, w, a, s, n, src_h, src_w, out_h,
                                       out_w, block_x, tile_h, smem_bytes,
                                       vec4, max_dy, fold_h, base_offset, st)
               : launch<C, SNAP, false>(v, c, w, a, s, n, src_h, src_w,
                                        out_h, out_w, block_x, tile_h,
                                        smem_bytes, vec4, max_dy, fold_h,
                                        base_offset, st);
}

}  // namespace

// values (n, src_h, src_w, channels), coords (.., 2), weights (.., 1) ->
// accum (n, out_h, out_w, channels) and wsum (.., 1), both zeroed by the
// caller; weights and wsum are both null (the values scattered
// unweighted, no wsum) or both given. block_x (a divisor of 256) columns by
// 256 / block_x rows of threads; tile_h source rows per block (a multiple
// of 256 / block_x); smem_bytes of dynamic shared memory for the box;
// vec4: float4 loads and atomics (channels 4, pointers 16-byte aligned).
// max_dy >= 0: the windowed splat, base row r % fold_h + base_offset
// (src_h a multiple of fold_h, base rows inside the target); max_dy < 0:
// unwindowed, fold_h and base_offset unused.
extern "C" int lsi_splat_fwd(const void* values, const void* coords,
                             const void* weights, void* accum, void* wsum,
                             int64_t n, int64_t src_h, int64_t src_w,
                             int channels, int64_t out_h, int64_t out_w,
                             int snap, int block_x, int tile_h,
                             int smem_bytes, int vec4, int max_dy,
                             int64_t fold_h, int64_t base_offset,
                             void* stream) {
  cudaError_t err = cudaSuccess;
  if (n * src_h * src_w == 0) return 0;
  if (block_x <= 0 || kThreads % block_x != 0 || tile_h <= 0 ||
      tile_h % (kThreads / block_x) != 0 || smem_bytes < 0 ||
      (vec4 && channels != 4) || (weights == nullptr) != (wsum == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool has_w = weights != nullptr;
  if (max_dy >= 0 && (fold_h <= 0 || src_h % fold_h != 0 ||
                      base_offset < 0 || base_offset + fold_h > out_h)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* v = static_cast<const float*>(values);
  const auto* c = static_cast<const float*>(coords);
  const auto* w = static_cast<const float*>(weights);
  auto* a = static_cast<float*>(accum);
  auto* s = static_cast<float*>(wsum);
  auto st = static_cast<cudaStream_t>(stream);
  const int fd = max_dy >= 0 ? static_cast<int>(fold_h) : 1;
  const int bo = max_dy >= 0 ? static_cast<int>(base_offset) : 0;
  switch (channels) {
#define LSI_SPLAT_CASE(CH)                                                  \
  case CH:                                                                  \
    err = snap ? launch_w<CH, true>(has_w, v, c, w, a, s, n, src_h, src_w, \
                                    out_h, out_w, block_x, tile_h,         \
                                    smem_bytes, vec4, max_dy, fd, bo, st)   \
               : launch_w<CH, false>(has_w, v, c, w, a, s, n, src_h,       \
                                     src_w, out_h, out_w, block_x, tile_h, \
                                     smem_bytes, vec4, max_dy, fd, bo, st); \
    break;
    LSI_SPLAT_CASE(1)
    LSI_SPLAT_CASE(2)
    LSI_SPLAT_CASE(3)
    LSI_SPLAT_CASE(4)
    LSI_SPLAT_CASE(5)
    LSI_SPLAT_CASE(6)
    LSI_SPLAT_CASE(7)
    LSI_SPLAT_CASE(8)
#undef LSI_SPLAT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
