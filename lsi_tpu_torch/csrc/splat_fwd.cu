// Forward bilinear splat (scatter-add) for Hopper (sm_90a).
//
// Replaces the TPU kernel lsi_tpu/kernels/splat_pallas.py:_splat_kernel
// (launched by splat_pallas). The TPU version builds per-row tent matrices
// and runs them through the matrix unit inside a static vertical window;
// here every source pixel scatters straight to its four target corners
// with float32 atomics, which gives the exact, unwindowed semantics of
// lsi_tpu/ops/splat.py:splat_bilinear (the plain version beside this
// kernel is lsi_tpu_torch/ops/splat.py).
//
// What bounds it on an H100: at the render's shape (N=8, Hs=L*H=512,
// Ws=768, C=4) there are ~3.1 M source pixels and up to 4*(C+1) = 20
// float32 atomics each (~63 M atomics), against ~88 MB read and ~31 MB of
// accumulators (which fit the 50 MB L2). Measured (PERF.md): the time
// grows with the atomics issued, not the bytes, and neighbouring threads
// that hit neighbouring targets raise the atomic rate ~2x. The bytes alone
// would take ~36 us; a call whose corners all fall off the image takes
// ~55 us, ~34 us of it the wrapper's zeroing; a random-target call ~730 us.
//
// Design, simple first: one thread per source pixel in a grid-stride
// loop; neighbouring threads read neighbouring pixels (coalesced loads);
// the [v*w, w] payload lives in registers; each in-bounds corner with a
// non-zero fraction gets C+1 atomicAdds. SNAP (the render) snaps the
// fractions as ops/splat.py does; without it the kernel is the exact
// transpose of the unsnapped bilinear gather (the gather's image
// gradient, lsi_tpu_torch/kernels/gather_cuda.py). Summation order across threads
// is not fixed, so results differ from run to run in the last bits.
// Bounds are tested in float BEFORE any float->int conversion: projected
// coordinates reach +-1e6 where the projection clamps its denominator,
// and an out-of-range float->int cast is undefined. Offsets are int64.
//
// Plain C interface (loaded with ctypes): launches on the calling
// thread's current device (the wrapper selects the tensors' device) and
// returns cudaGetLastError() after the launch, 0 on success.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kMinFraction = 1e-4f;  // ops/splat.py MIN_FRACTION

__device__ __forceinline__ float snap_fraction(float f) {
  if (f < kMinFraction) return 0.0f;
  if (f > 1.0f - kMinFraction) return 1.0f;
  return f;
}

template <int C, bool SNAP>
__global__ void splat_fwd_kernel(const float* __restrict__ values,
                                 const float* __restrict__ coords,
                                 const float* __restrict__ weights,
                                 float* __restrict__ accum,
                                 float* __restrict__ wsum,
                                 int64_t total, int64_t pixels_per_image,
                                 int64_t out_h, int64_t out_w) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const float x = coords[2 * i];
    const float y = coords[2 * i + 1];
    const float w = weights[i];
    float pay[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) pay[ch] = values[i * C + ch] * w;

    const float x0 = floorf(x);
    const float y0 = floorf(y);
    const float fx = SNAP ? snap_fraction(x - x0) : x - x0;
    const float fy = SNAP ? snap_fraction(y - y0) : y - y0;
    const int64_t img_off = (i / pixels_per_image) * out_h * out_w;

#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {
      const int dy = corner >> 1;
      const int dx = corner & 1;
      const float frac = (dx ? fx : 1.0f - fx) * (dy ? fy : 1.0f - fy);
      const float xi = x0 + dx;
      const float yi = y0 + dy;
      // NaN coordinates fail every comparison and are dropped too.
      if (!(frac > 0.0f && xi >= 0.0f && xi <= out_w - 1 && yi >= 0.0f &&
            yi <= out_h - 1)) {
        continue;
      }
      const int64_t t = img_off + static_cast<int64_t>(yi) * out_w +
                        static_cast<int64_t>(xi);
#pragma unroll
      for (int ch = 0; ch < C; ++ch) atomicAdd(&accum[t * C + ch], pay[ch] * frac);
      atomicAdd(&wsum[t], w * frac);
    }
  }
}

template <int C, bool SNAP>
cudaError_t launch(const float* values, const float* coords,
                   const float* weights, float* accum, float* wsum,
                   int64_t total, int64_t pixels_per_image, int64_t out_h,
                   int64_t out_w, cudaStream_t stream) {
  constexpr int kThreads = 256;
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t wanted = (total + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  const int blocks = static_cast<int>(wanted < cap ? wanted : cap);
  splat_fwd_kernel<C, SNAP><<<blocks, kThreads, 0, stream>>>(
      values, coords, weights, accum, wsum, total, pixels_per_image, out_h,
      out_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lsi_splat_fwd(const void* values, const void* coords,
                             const void* weights, void* accum, void* wsum,
                             int64_t n, int64_t src_h, int64_t src_w,
                             int channels, int64_t out_h, int64_t out_w,
                             int snap, void* stream) {
  cudaError_t err = cudaSuccess;
  const int64_t pixels_per_image = src_h * src_w;
  const int64_t total = n * pixels_per_image;
  if (total == 0) return 0;
  const auto* v = static_cast<const float*>(values);
  const auto* c = static_cast<const float*>(coords);
  const auto* w = static_cast<const float*>(weights);
  auto* a = static_cast<float*>(accum);
  auto* s = static_cast<float*>(wsum);
  auto st = static_cast<cudaStream_t>(stream);
  switch (channels) {
#define LSI_SPLAT_CASE(CH)                                                   \
  case CH:                                                                   \
    err = snap ? launch<CH, true>(v, c, w, a, s, total, pixels_per_image,   \
                                  out_h, out_w, st)                          \
               : launch<CH, false>(v, c, w, a, s, total, pixels_per_image,  \
                                   out_h, out_w, st);                        \
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
