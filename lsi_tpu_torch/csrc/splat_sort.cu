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
// one fixed order, from 0.0, with no atomics. The plain version beside
// this kernel is lsi_tpu_torch/ops/splat.py (method="sort").
//
// Three steps, launched by lsi_tpu_torch/kernels/splat_cuda.py:splat
// (deterministic=True):
//   1. lsi_splat_sort_keys: one thread per source pixel writes the int32
//      target index of each of its four corners, or INT_MAX (which sorts
//      last) for a dropped corner, at position q = k * N * P + i (corner
//      k, source pixel i = n * P + p): JAX's corner-major order. The
//      corner test is K1's (csrc/splat_fwd.cu:corners): the bounds are
//      tested in float before any conversion (H9), a NaN fails every test
//      and is dropped, a corner with fraction 0 adds nothing and is
//      dropped, and with max_dy >= 0 the window [base - max_dy, base +
//      max_dy + 1], base = r % fold_h + base_offset.
//   2. A stable torch.sort of those keys, which carries the positions q.
//      JAX's argsort runs outside any Pallas kernel too; the sort moves 12
//      bytes a corner (the key and its int64 position), not the C + 1
//      floats of a contribution.
//   3. lsi_splat_sort_sum: one thread per target pixel finds its run in
//      the sorted keys (a binary search) and recomputes each contribution
//      from its position: the corner's fraction from the coordinates, w *
//      frac and (v * w) * frac, as the plain version forms them. It adds
//      them in sorted order with __fadd_rn/__fmul_rn, which the compiler
//      may not contract into FMAs, so the kernel's products and sums are
//      the plain version's, and flushes a denormal sum to zero as K1's
//      global atomics do (H12). Every pixel of accum and wsum is written
//      with a plain store, so the wrapper allocates them with torch.empty.
//
// Bound: the same bytes as K1 for the same shape (values, coords and
// weights read once, accum and wsum written once), e.g. 35.7 us on the b8
// render's inputs (8, 512, 768, 4) -> (256, 768) at 3.35 TB/s. This simple
// design moves more: 4 bytes a corner written and read as keys, the sort's
// passes over 12 bytes a corner, a binary search of ~log2(4 N P) reads a
// target pixel, and a gather of coordinates, values and weights for each
// live corner. What it costs against the bound is in PERF.md §6.
//
// Offsets: the keys and the target index are int32, so N * out_h * out_w
// must be below INT_MAX and 4 * N * src_h * src_w below 2^31 (the wrapper
// raises ValueError otherwise); source offsets inside the kernels are
// int64.
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// calling thread's current device and returns cudaGetLastError() after the
// launch, 0 on success.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kMinFraction = 1e-4f;  // ops/splat.py MIN_FRACTION
constexpr int kThreads = 256;
constexpr int kDropped = INT_MAX;      // sorts after every target

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

template <bool SNAP>
__global__ void __launch_bounds__(kThreads)
    splat_sort_keys_kernel(const float2* __restrict__ coords,
                           int* __restrict__ keys, int64_t np, int src_h,
                           int src_w, int out_h, int out_w, int max_dy,
                           int fold_h, int base_offset) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  if (i >= np) return;
  const int64_t pixels = static_cast<int64_t>(src_h) * src_w;
  const int64_t n = i / pixels;
  const int row = static_cast<int>((i - n * pixels) / src_w);
  const int base = row % fold_h + base_offset;
  float x0, y0, fx, fy;
  fractions<SNAP>(coords[i], x0, y0, fx, fy);
  const int image = static_cast<int>(n) * out_h * out_w;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float xf = x0 + static_cast<float>(k & 1);
    const float yf = y0 + static_cast<float>(k >> 1);
    // NaN coordinates fail every comparison and are dropped too.
    bool live = corner_fraction(k, fx, fy) > 0.0f && xf >= 0.0f &&
                xf <= static_cast<float>(out_w - 1) && yf >= 0.0f &&
                yf <= static_cast<float>(out_h - 1);
    if (max_dy >= 0) {
      // Exact in float: it decides only for rows inside the target.
      const float ky = yf - static_cast<float>(base);
      live = live && ky >= static_cast<float>(-max_dy) &&
             ky <= static_cast<float>(max_dy + 1);
    }
    keys[k * np + i] =
        live ? image + static_cast<int>(yf) * out_w + static_cast<int>(xf)
             : kDropped;
  }
}

template <int C, bool SNAP, bool HAS_W>
__global__ void __launch_bounds__(kThreads)
    splat_sort_sum_kernel(const float* __restrict__ values,
                          const float2* __restrict__ coords,
                          const float* __restrict__ weights,
                          const int* __restrict__ sorted_keys,
                          const int64_t* __restrict__ order,
                          float* __restrict__ accum, float* __restrict__ wsum,
                          int64_t np, int targets) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= targets) return;
  const int64_t corners = 4 * np;
  // The first sorted key >= t.
  int64_t lo = 0, hi = corners;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (sorted_keys[mid] < t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  float acc[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
  float ws = 0.0f;
  for (int64_t j = lo; j < corners && sorted_keys[j] == t; ++j) {
    const int64_t q = order[j];
    const int k = static_cast<int>(q / np);
    const int64_t i = q - k * np;
    float x0, y0, fx, fy;
    fractions<SNAP>(coords[i], x0, y0, fx, fy);
    const float frac = corner_fraction(k, fx, fy);
    const float w = HAS_W ? weights[i] : 1.0f;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const float v = values[i * C + ch];
      const float vw = HAS_W ? __fmul_rn(v, w) : v;
      acc[ch] = __fadd_rn(acc[ch], __fmul_rn(vw, frac));
    }
    if (HAS_W) ws = __fadd_rn(ws, __fmul_rn(w, frac));
  }
  const int64_t out = static_cast<int64_t>(t) * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) accum[out + ch] = flushed(acc[ch]);
  if (HAS_W) wsum[t] = flushed(ws);
}

int blocks(int64_t threads) {
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

template <int C, bool SNAP>
cudaError_t launch_sum(const float* v, const float2* c, const float* w,
                       const int* k, const int64_t* o, float* a, float* s,
                       int64_t np, int targets, cudaStream_t st) {
  if (w != nullptr) {
    splat_sort_sum_kernel<C, SNAP, true>
        <<<blocks(targets), kThreads, 0, st>>>(v, c, w, k, o, a, s, np,
                                               targets);
  } else {
    splat_sort_sum_kernel<C, SNAP, false>
        <<<blocks(targets), kThreads, 0, st>>>(v, c, w, k, o, a, s, np,
                                               targets);
  }
  return cudaGetLastError();
}

// The sizes both entry points check: the keys and the targets must fit
// int32 (kDropped above every target), the grid CUDA's x limit.
bool sizes_fit(int64_t n, int64_t src_h, int64_t src_w, int64_t out_h,
               int64_t out_w) {
  const int64_t np = n * src_h * src_w;
  const int64_t targets = n * out_h * out_w;
  return n > 0 && src_h > 0 && src_w > 0 && out_h > 0 && out_w > 0 &&
         4 * np < (int64_t{1} << 31) && targets < INT_MAX;
}

}  // namespace

// coords (n, src_h, src_w, 2) -> keys (4 * n * src_h * src_w) int32, the
// target index n * out_h * out_w + y * out_w + x of each corner (corner-
// major), INT_MAX where the corner is dropped. snap: snap the fractions.
// max_dy >= 0: the windowed splat, base row r % fold_h + base_offset
// (src_h a multiple of fold_h, base rows inside the target); max_dy < 0:
// unwindowed, fold_h and base_offset unused.
extern "C" int lsi_splat_sort_keys(const void* coords, void* keys, int64_t n,
                                   int64_t src_h, int64_t src_w,
                                   int64_t out_h, int64_t out_w, int snap,
                                   int max_dy, int64_t fold_h,
                                   int64_t base_offset, void* stream) {
  if (!sizes_fit(n, src_h, src_w, out_h, out_w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (max_dy >= 0 && (fold_h <= 0 || src_h % fold_h != 0 ||
                      base_offset < 0 || base_offset + fold_h > out_h)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int fd = max_dy >= 0 ? static_cast<int>(fold_h) : 1;
  const int bo = max_dy >= 0 ? static_cast<int>(base_offset) : 0;
  const int64_t np = n * src_h * src_w;
  const auto* c = static_cast<const float2*>(coords);
  auto* k = static_cast<int*>(keys);
  auto st = static_cast<cudaStream_t>(stream);
  if (snap) {
    splat_sort_keys_kernel<true><<<blocks(np), kThreads, 0, st>>>(
        c, k, np, static_cast<int>(src_h), static_cast<int>(src_w),
        static_cast<int>(out_h), static_cast<int>(out_w), max_dy, fd, bo);
  } else {
    splat_sort_keys_kernel<false><<<blocks(np), kThreads, 0, st>>>(
        c, k, np, static_cast<int>(src_h), static_cast<int>(src_w),
        static_cast<int>(out_h), static_cast<int>(out_w), max_dy, fd, bo);
  }
  return static_cast<int>(cudaGetLastError());
}

// values (n, src_h, src_w, channels), coords (.., 2), weights (.., 1) or
// null, the keys sorted stably (sorted_keys, 4 * n * src_h * src_w int32)
// and their positions (order, int64) -> accum (n, out_h, out_w, channels)
// and wsum (.., 1) (null with null weights), every pixel written.
extern "C" int lsi_splat_sort_sum(const void* values, const void* coords,
                                  const void* weights,
                                  const void* sorted_keys, const void* order,
                                  void* accum, void* wsum, int64_t n,
                                  int64_t src_h, int64_t src_w, int channels,
                                  int64_t out_h, int64_t out_w, int snap,
                                  void* stream) {
  if (!sizes_fit(n, src_h, src_w, out_h, out_w) ||
      (weights == nullptr) != (wsum == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* v = static_cast<const float*>(values);
  const auto* c = static_cast<const float2*>(coords);
  const auto* w = static_cast<const float*>(weights);
  const auto* k = static_cast<const int*>(sorted_keys);
  const auto* o = static_cast<const int64_t*>(order);
  auto* a = static_cast<float*>(accum);
  auto* s = static_cast<float*>(wsum);
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t np = n * src_h * src_w;
  const int targets = static_cast<int>(n * out_h * out_w);
  cudaError_t err = cudaSuccess;
  switch (channels) {
#define LSI_SORT_CASE(CH)                                                  \
  case CH:                                                                 \
    err = snap ? launch_sum<CH, true>(v, c, w, k, o, a, s, np, targets, st) \
               : launch_sum<CH, false>(v, c, w, k, o, a, s, np, targets,   \
                                       st);                                \
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
