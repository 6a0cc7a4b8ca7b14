// Splat backward and bilinear gather for Hopper (sm_90a): three entry
// points; the two backward ones share one per-pixel device function.
//
// Replaces the TPU kernel lsi_tpu/kernels/splat_pallas.py:_splat_bwd_kernel
// (launched by splat_pallas_bwd_sums; K2) in its two roles:
//   * the splat's VJP, whose combine splat_pallas_diff._bwd does outside
//     the kernel (K3): lsi_splat_vjp fuses it in;
//   * the gather of lsi_tpu/kernels/gather_pallas.py:gather_pallas_diff
//     (K4), forward (lsi_gather_fwd) and coordinate backward
//     (lsi_gather_bwd_coords).
// The TPU kernel turns the per-pixel gathers into tent-matrix products on
// the MXU inside a static vertical window, because the TPU serialises
// gathers. Here each thread reads its own pixel's four bilinear corners:
// a gather, with no atomics, so every output is written by one thread and
// the results repeat bitwise. The semantics are those of the JAX lax
// oracles: the splat's VJP uses the snapped fractions and has
// a zero coordinate gradient where a fraction lies in a snap zone
// (lsi_tpu/ops/splat.py:snap_fraction under autodiff, as
// splat_pallas.py:_bwd_gather shows); the gather does not snap
// (lsi_tpu/ops/gather.py). The compile-time SNAP switch is that one
// difference. The plain versions beside these kernels are
// lsi_tpu_torch/ops/splat.py (tent_sums, splat_bilinear under autograd)
// and lsi_tpu_torch/ops/gather.py.
//
// The splat's VJP also has the TPU kernel's windowed mode (max_dy >= 0),
// the gradient of lsi_splat_fwd's windowed splat for the height-sharded
// render: a corner whose row yi has yi - base outside [-max_dy,
// max_dy + 1], base = r % fold_h + base_offset for source row r, counts
// as outside the image, so it adds nothing to S0, SX or SY (the gradients
// masked to the window, as splat_pallas.py:splat_pallas_diff's are). The
// window is one more test in the shared corner function.
//
// The two gathers have the same windowed mode (K4-W, max_dy >= 0): the
// semantics of gather_pallas.py:gather_pallas_diff, whose forward is K2's
// S0 of [image, 1] and whose coordinate gradient is its SX and SY. They
// take the corner function with SNAP and the window at base = r % fold_h:
// snapped fractions, a corner outside the window dropped from sampled and
// valid, and a coordinate gradient of 0 where a fraction lies in a snap
// zone. The mode is a template parameter (its own kernel), so with
// max_dy = -1 the exact lax gather runs the code it ran before, bitwise.
// The window adds one test per corner to a kernel bound by bytes.
//
// Per source pixel at (x, y) with corners k = 00, 01 (x+1), 10 (y+1), 11,
// fractions fx, fy and I_k the input at corner k (0 outside the image):
//   S0 = sum_k frac_k I_k
//   SX = (1-fy)(I01-I00) + fy(I11-I10),   SY = (1-fx)(I10-I00) + fx(I11-I01)
// lsi_splat_vjp (I = [g_accum, g_wsum], v the values, w the weight):
//   d_values = w S0,   d_weights = sum_c v_c S0_c + S0_w,
//   d_coords = w (sum_c v_c SX_c + SX_w, sum_c v_c SY_c + SY_w), 0 in snap
//   zones; computed as q_k = v . g_accum[k] + g_wsum[k] per corner.
// lsi_gather_fwd (I = [image, 1]): sampled = S0, valid = S0_ones.
// lsi_gather_bwd_coords: d_coords = sum_c g_sampled_c SX_c + g_valid SX_1
//   (and SY), from q_k = g_sampled . image[k] + g_valid per in-image corner;
//   SX and SY are recomputed instead of being saved by the forward.
//
// What bounds them on an H100: bytes. At the training shape (N=16,
// Hs=L*H=768, Ws=768, 9.44 M source pixels) each pixel reads and writes a
// few floats of its own (coalesced) and gathers four corners of a
// (16, 256, 768, C) image (63 MB at C=5) that the 50 MB L2 mostly serves,
// since neighbouring threads read neighbouring corners. Bytes, each
// tensor once: lsi_splat_vjp ~590 MB, lsi_gather_fwd ~264 MB,
// lsi_gather_bwd_coords ~340 MB, i.e. ~176 / 79 / 100 us at 3.35 TB/s.
// Fusing K3's combine into the kernel avoids the TPU layout's
// (N, Hs, 3, C1, Ws) intermediate (566 MB written and read back); not
// saving SX/SY from the gather's forward avoids 302 MB of activations.
//
// Design of lsi_splat_vjp and lsi_gather_bwd_coords, simple first: one
// thread per source pixel in a grid-stride loop, the pixel's inputs and
// sums in registers, C a template parameter (1..8); offsets are int64. An
// output pointer may be null: that output is not written (the autograd
// wrapper asks only for the gradients it needs).
//
// Design of lsi_gather_fwd, for Hopper. A first, simple form (the design
// of the two kernels above) lost to one F.grid_sample call (201 vs 190 us
// at the b16 inverse warp; PERF.md): two
// scalar coordinate loads, an int64 division and int64 offsets per pixel,
// one pixel in flight per thread. Now one CTA of 256 threads takes 256
// columns of tile_rows (<= 4) source rows of one image: no division by
// the image size, 32-bit offsets inside an image. The inverse warp folds
// its L layers into rows r, r+H, r+2H, which sample the same image rows,
// so the wrapper gives a tile those rows (row_stride = H) and their
// corners share L1. A thread loads all its rows' coordinates (float2)
// before it reads any corner, so up to 4 pixels' corner reads are in
// flight at once. Two parts of the first design measured slower on the
// inverse warp's own inputs and went (PERF.md): staging the image
// rows a tile reaches in shared memory (cp.async; it won only on
// scattered coordinates, which L1 serves badly) and writing the outputs
// through shared memory as 16-byte stores. The per-pixel arithmetic is
// simple form's, in the same order: results are bitwise the same.
//
// Bounds are tested in float BEFORE any float->int conversion
// (coordinates reach +-1e6 where the projection clamps its denominator).
//
// Plain C interface (loaded with ctypes): each entry point launches on the
// calling thread's current device and returns cudaGetLastError() after
// the launch, 0 on success.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kMinFraction = 1e-4f;  // ops/splat.py MIN_FRACTION
constexpr int kThreads = 256;
constexpr int kMaxTileRows = 4;  // lsi_gather_fwd's rows per block, at most

__device__ __forceinline__ float snap_fraction(float f) {
  if (f < kMinFraction) return 0.0f;
  if (f > 1.0f - kMinFraction) return 1.0f;
  return f;
}

// The bilinear neighbourhood of one coordinate in an h x w image; with
// max_dy >= 0, only the corners whose row lies in [base - max_dy,
// base + max_dy + 1].
struct Corners {
  float fx, fy;       // fractions, snapped when SNAP
  bool live_x, live_y;  // the fraction carries a gradient (not snapped)
  int64_t off[4];     // pixel offsets of corners 00, 01, 10, 11; -1 outside
  float frac[4];      // bilinear weights of the four corners
};

template <bool SNAP>
__device__ __forceinline__ Corners corners(float x, float y, int64_t img_off,
                                           int64_t h, int64_t w,
                                           int64_t base = 0,
                                           int max_dy = -1) {
  Corners c;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  // A non-finite coordinate drops the pixel: no corner in the image (the
  // bounds test below fails for inf and nan), fractions 0 and no gradient.
  // (The lax reference's gradient is nan there.)
  const bool finite = isfinite(x) && isfinite(y);
  const float fx_raw = finite ? x - x0 : 0.0f;
  const float fy_raw = finite ? y - y0 : 0.0f;
  if (SNAP) {
    // Inverse of snap_fraction's zones.
    c.live_x = fx_raw >= kMinFraction && fx_raw <= 1.0f - kMinFraction;
    c.live_y = fy_raw >= kMinFraction && fy_raw <= 1.0f - kMinFraction;
    c.fx = snap_fraction(fx_raw);
    c.fy = snap_fraction(fy_raw);
  } else {
    c.live_x = c.live_y = finite;
    c.fx = fx_raw;
    c.fy = fy_raw;
  }
  c.frac[0] = (1.0f - c.fx) * (1.0f - c.fy);
  c.frac[1] = c.fx * (1.0f - c.fy);
  c.frac[2] = (1.0f - c.fx) * c.fy;
  c.frac[3] = c.fx * c.fy;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float xi = x0 + (k & 1);
    const float yi = y0 + (k >> 1);
    // NaN coordinates fail every comparison: all corners outside.
    bool inb = xi >= 0.0f && xi <= static_cast<float>(w - 1) &&
               yi >= 0.0f && yi <= static_cast<float>(h - 1);
    // Exact in float: it decides only for rows inside the image.
    if (max_dy >= 0) {
      const float ky = yi - static_cast<float>(base);
      inb = inb && ky >= static_cast<float>(-max_dy) &&
            ky <= static_cast<float>(max_dy + 1);
    }
    c.off[k] = inb ? img_off + static_cast<int64_t>(yi) * w +
                         static_cast<int64_t>(xi)
                   : -1;
  }
  return c;
}

// (x, y) derivative of sum_k frac_k q_k.
__device__ __forceinline__ void tent_grad(const Corners& c, const float q[4],
                                          float* gx, float* gy) {
  *gx = (1.0f - c.fy) * (q[1] - q[0]) + c.fy * (q[3] - q[2]);
  *gy = (1.0f - c.fx) * (q[2] - q[0]) + c.fx * (q[3] - q[1]);
}

template <int C>
__global__ void splat_vjp_kernel(
    const float* __restrict__ values, const float* __restrict__ coords,
    const float* __restrict__ weights, const float* __restrict__ g_accum,
    const float* __restrict__ g_wsum, float* __restrict__ d_values,
    float* __restrict__ d_coords, float* __restrict__ d_weights,
    int64_t total, int64_t pixels_per_image, int64_t out_h, int64_t out_w,
    int64_t src_w, int max_dy, int64_t fold_h, int64_t base_offset) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int64_t base =
        max_dy >= 0 ? (i % pixels_per_image) / src_w % fold_h + base_offset
                    : 0;
    const Corners c =
        corners<true>(coords[2 * i], coords[2 * i + 1],
                      (i / pixels_per_image) * out_h * out_w, out_h, out_w,
                      base, max_dy);
    float v[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) v[ch] = values[i * C + ch];
    const float w = weights[i];

    float s0[C];
    float s0_w = 0.0f;
    float q[4];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) s0[ch] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      q[k] = 0.0f;
      if (c.off[k] < 0) continue;
      const float gw = g_wsum[c.off[k]];
      float dot = 0.0f;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        const float ga = g_accum[c.off[k] * C + ch];
        s0[ch] += c.frac[k] * ga;
        dot += v[ch] * ga;
      }
      s0_w += c.frac[k] * gw;
      q[k] = dot + gw;
    }

    if (d_values != nullptr) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) d_values[i * C + ch] = w * s0[ch];
    }
    if (d_weights != nullptr) {
      float dw = 0.0f;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) dw += v[ch] * s0[ch];
      d_weights[i] = dw + s0_w;
    }
    if (d_coords != nullptr) {
      float gx, gy;
      tent_grad(c, q, &gx, &gy);
      d_coords[2 * i] = c.live_x ? w * gx : 0.0f;
      d_coords[2 * i + 1] = c.live_y ? w * gy : 0.0f;
    }
  }
}

// The gather's forward, tiled (see "lsi_gather_fwd" in the header note).
// Block (blockIdx.x, blockIdx.y, blockIdx.z = image) takes columns
// [blockIdx.x * kThreads, + kThreads) of tile_rows source rows spaced
// row_stride apart: rows base + j * row_stride, j < tile_rows, with
// base = (blockIdx.y / row_stride) * row_stride * tile_rows +
// blockIdx.y % row_stride (lsi_tpu_torch/kernels/gather_cuda.py:
// gather_tile_rows is the same map).
__device__ __forceinline__ int gather_tile_row(int group, int j,
                                               int row_stride,
                                               int tile_rows) {
  return (group / row_stride) * row_stride * tile_rows + group % row_stride +
         j * row_stride;
}

// WINDOW: K4-W (snapped, windowed at base row r % fold_h), a separate
// instantiation so that the exact gather's code is what it was.
template <int C, bool WINDOW>
__global__ void __launch_bounds__(kThreads)
    gather_fwd_kernel(const float* __restrict__ image,
                      const float* __restrict__ coords,
                      float* __restrict__ sampled, float* __restrict__ valid,
                      int src_h, int src_w, int img_h, int img_w,
                      int tile_rows, int row_stride, int max_dy,
                      int fold_h) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  const int64_t src_base = static_cast<int64_t>(blockIdx.z) * src_h * src_w;
  const float* img =
      image + static_cast<int64_t>(blockIdx.z) * img_h * img_w * C;
  const float2* xy = reinterpret_cast<const float2*>(coords) + src_base;

  // The tile's coordinates, all loaded before any corner is read.
  float2 q[kMaxTileRows];
  int p[kMaxTileRows];
  bool on[kMaxTileRows];
#pragma unroll
  for (int j = 0; j < kMaxTileRows; ++j) {
    const int r = gather_tile_row(blockIdx.y, j, row_stride, tile_rows);
    on[j] = j < tile_rows && r < src_h && col < src_w;
    p[j] = r * src_w + col;
    q[j] = on[j] ? xy[p[j]] : make_float2(0.0f, 0.0f);
  }

#pragma unroll
  for (int j = 0; j < kMaxTileRows; ++j) {
    if (!on[j]) continue;
    if constexpr (WINDOW) {
      const int r = gather_tile_row(blockIdx.y, j, row_stride, tile_rows);
      const Corners c =
          corners<true>(q[j].x, q[j].y, 0, img_h, img_w, r % fold_h, max_dy);
      float acc[C];
      float mass = 0.0f;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (c.off[k] < 0) continue;
        const float* px = &img[c.off[k] * C];
#pragma unroll
        for (int ch = 0; ch < C; ++ch) acc[ch] += px[ch] * c.frac[k];
        mass += c.frac[k];
      }
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        sampled[(src_base + p[j]) * C + ch] = acc[ch];
      }
      valid[src_base + p[j]] = mass;
      continue;
    }
    const float x0 = floorf(q[j].x);
    const float y0 = floorf(q[j].y);
    const float fx = q[j].x - x0;
    const float fy = q[j].y - y0;
    const float frac[4] = {(1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                           (1.0f - fx) * fy, fx * fy};
    float acc[C];
    float mass = 0.0f;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float xf = x0 + (k & 1);
      const float yf = y0 + (k >> 1);
      // NaN coordinates fail every comparison: all corners outside.
      if (!(xf >= 0.0f && xf <= static_cast<float>(img_w - 1) &&
            yf >= 0.0f && yf <= static_cast<float>(img_h - 1))) {
        continue;
      }
      const float* px = &img[(static_cast<int>(yf) * img_w +
                              static_cast<int>(xf)) * C];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) acc[ch] += px[ch] * frac[k];
      mass += frac[k];
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch) sampled[(src_base + p[j]) * C + ch] = acc[ch];
    valid[src_base + p[j]] = mass;
  }
}

// WINDOW: K4-W (snapped, windowed at base row r % fold_h), a separate
// instantiation so that the exact gather's code is what it was.
template <int C, bool WINDOW>
__global__ void gather_bwd_coords_kernel(
    const float* __restrict__ image, const float* __restrict__ coords,
    const float* __restrict__ g_sampled, const float* __restrict__ g_valid,
    float* __restrict__ d_coords, int64_t total, int64_t pixels_per_image,
    int64_t img_h, int64_t img_w, int64_t src_w, int max_dy,
    int64_t fold_h) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const Corners c = corners<WINDOW>(
        coords[2 * i], coords[2 * i + 1],
        (i / pixels_per_image) * img_h * img_w, img_h, img_w,
        WINDOW ? (i % pixels_per_image) / src_w % fold_h : 0,
        WINDOW ? max_dy : -1);
    float g[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) g[ch] = g_sampled[i * C + ch];
    const float gv = g_valid[i];
    float q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      q[k] = 0.0f;
      if (c.off[k] < 0) continue;
      float dot = 0.0f;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) dot += g[ch] * image[c.off[k] * C + ch];
      q[k] = dot + gv;
    }
    float gx, gy;
    tent_grad(c, q, &gx, &gy);
    d_coords[2 * i] = !WINDOW || c.live_x ? gx : 0.0f;
    d_coords[2 * i + 1] = !WINDOW || c.live_y ? gy : 0.0f;
  }
}

// Grid for a grid-stride loop over `total` pixels: at most 16 blocks of
// kThreads per SM.
cudaError_t grid_for(int64_t total, int* blocks) {
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t wanted = (total + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  *blocks = static_cast<int>(wanted < cap ? wanted : cap);
  return cudaSuccess;
}

}  // namespace

// Dispatch on the channel count (1..8) to KERNEL<CH>, then report the
// launch's error.
#define LSI_LAUNCH_BY_CHANNELS(KERNEL, CHANNELS, TOTAL, STREAM, ...)       \
  do {                                                                    \
    if ((TOTAL) == 0) return 0;                                           \
    int blocks = 0;                                                       \
    cudaError_t err = grid_for((TOTAL), &blocks);                         \
    if (err != cudaSuccess) return static_cast<int>(err);                 \
    auto st = static_cast<cudaStream_t>(STREAM);                          \
    switch (CHANNELS) {                                                   \
      case 1: KERNEL<1><<<blocks, kThreads, 0, st>>>(__VA_ARGS__); break; \
      case 2: KERNEL<2><<<blocks, kThreads, 0, st>>>(__VA_ARGS__); break; \
      case 3: KERNEL<3><<<blocks, kThreads, 0, st>>>(__VA_ARGS__); break; \
      case 4: KERNEL<4><<<blocks, kThreads, 0, st>>>(__VA_ARGS__); break; \
      case 5: KERNEL<5><<<blocks, kThreads, 0, st>>>(__VA_ARGS__); break; \
      case 6: KERNEL<6><<<blocks, kThreads, 0, st>>>(__VA_ARGS__); break; \
      case 7: KERNEL<7><<<blocks, kThreads, 0, st>>>(__VA_ARGS__); break; \
      case 8: KERNEL<8><<<blocks, kThreads, 0, st>>>(__VA_ARGS__); break; \
      default: return static_cast<int>(cudaErrorInvalidValue);            \
    }                                                                     \
    return static_cast<int>(cudaGetLastError());                          \
  } while (0)

// The splat's VJP (K2 + K3). values (n, src_h, src_w, channels), coords
// (.., 2), weights (.., 1), g_accum (n, out_h, out_w, channels), g_wsum
// (.., 1) -> d_values, d_coords, d_weights shaped as values, coords,
// weights (each may be null). max_dy >= 0: the windowed splat's VJP, base
// row r % fold_h + base_offset (as lsi_splat_fwd); max_dy < 0: unwindowed.
extern "C" int lsi_splat_vjp(const void* values, const void* coords,
                             const void* weights, const void* g_accum,
                             const void* g_wsum, void* d_values,
                             void* d_coords, void* d_weights, int64_t n,
                             int64_t src_h, int64_t src_w, int channels,
                             int64_t out_h, int64_t out_w, int max_dy,
                             int64_t fold_h, int64_t base_offset,
                             void* stream) {
  if (max_dy >= 0 && (fold_h <= 0 || src_h % fold_h != 0 ||
                      base_offset < 0 || base_offset + fold_h > out_h)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t ppi = src_h * src_w;
  LSI_LAUNCH_BY_CHANNELS(
      splat_vjp_kernel, channels, n * ppi, stream,
      static_cast<const float*>(values), static_cast<const float*>(coords),
      static_cast<const float*>(weights), static_cast<const float*>(g_accum),
      static_cast<const float*>(g_wsum), static_cast<float*>(d_values),
      static_cast<float*>(d_coords), static_cast<float*>(d_weights), n * ppi,
      ppi, out_h, out_w, src_w, max_dy, max_dy >= 0 ? fold_h : 1,
      base_offset);
}

// The windowed gathers' contract: base rows r % fold_h inside the image.
static bool bad_gather_window(int max_dy, int64_t fold_h, int64_t src_h,
                       int64_t img_h) {
  return max_dy >= 0 &&
         (fold_h <= 0 || fold_h > img_h || src_h % fold_h != 0);
}

// The gather's forward (K4). image (n, img_h, img_w, channels), coords
// (n, src_h, src_w, 2), 8-byte aligned -> sampled (n, src_h, src_w,
// channels), valid (.., 1). Grid (ceil(src_w / 256), row_groups, n) of
// 256 threads; tile_rows (<= 4) rows spaced row_stride apart per block.
// max_dy >= 0: K4-W, snapped and windowed at base row r % fold_h;
// max_dy < 0: the exact gather.
extern "C" int lsi_gather_fwd(const void* image, const void* coords,
                              void* sampled, void* valid, int64_t n,
                              int64_t src_h, int64_t src_w, int channels,
                              int64_t img_h, int64_t img_w, int row_groups,
                              int tile_rows, int row_stride, int max_dy,
                              int64_t fold_h, void* stream) {
  if (n * src_h * src_w == 0) return 0;
  if (tile_rows <= 0 || tile_rows > kMaxTileRows || row_stride <= 0 ||
      row_groups <= 0 || channels < 1 || channels > 8 ||
      bad_gather_window(max_dy, fold_h, src_h, img_h)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((src_w + kThreads - 1) / kThreads, row_groups, n);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* im = static_cast<const float*>(image);
  const auto* c = static_cast<const float*>(coords);
  auto* s = static_cast<float*>(sampled);
  auto* v = static_cast<float*>(valid);
  switch (channels) {
#define LSI_GATHER_FWD_ARGS                                                  \
  im, c, s, v, static_cast<int>(src_h), static_cast<int>(src_w),             \
      static_cast<int>(img_h), static_cast<int>(img_w), tile_rows,           \
      row_stride, max_dy, static_cast<int>(max_dy >= 0 ? fold_h : 1)
#define LSI_GATHER_CASE(CH)                                                  \
  case CH:                                                                   \
    if (max_dy >= 0) {                                                       \
      gather_fwd_kernel<CH, true>                                            \
          <<<grid, kThreads, 0, st>>>(LSI_GATHER_FWD_ARGS);                  \
    } else {                                                                 \
      gather_fwd_kernel<CH, false>                                           \
          <<<grid, kThreads, 0, st>>>(LSI_GATHER_FWD_ARGS);                  \
    }                                                                        \
    break;
    LSI_GATHER_CASE(1)
    LSI_GATHER_CASE(2)
    LSI_GATHER_CASE(3)
    LSI_GATHER_CASE(4)
    LSI_GATHER_CASE(5)
    LSI_GATHER_CASE(6)
    LSI_GATHER_CASE(7)
    LSI_GATHER_CASE(8)
#undef LSI_GATHER_CASE
#undef LSI_GATHER_FWD_ARGS
  }
  return static_cast<int>(cudaGetLastError());
}

// The gather's coordinate cotangent (K4 backward). g_sampled shaped as
// sampled, g_valid as valid -> d_coords shaped as coords. max_dy and
// fold_h as lsi_gather_fwd's.
extern "C" int lsi_gather_bwd_coords(const void* image, const void* coords,
                                     const void* g_sampled,
                                     const void* g_valid, void* d_coords,
                                     int64_t n, int64_t src_h, int64_t src_w,
                                     int channels, int64_t img_h,
                                     int64_t img_w, int max_dy,
                                     int64_t fold_h, void* stream) {
  if (bad_gather_window(max_dy, fold_h, src_h, img_h)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = n * src_h * src_w;
  if (total == 0) return 0;
  if (channels < 1 || channels > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int blocks = 0;
  cudaError_t err = grid_for(total, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* im = static_cast<const float*>(image);
  const auto* c = static_cast<const float*>(coords);
  const auto* gs = static_cast<const float*>(g_sampled);
  const auto* gv = static_cast<const float*>(g_valid);
  auto* d = static_cast<float*>(d_coords);
  switch (channels) {
#define LSI_GATHER_BWD_ARGS                                                  \
  im, c, gs, gv, d, total, src_h * src_w, img_h, img_w, src_w, max_dy,       \
      max_dy >= 0 ? fold_h : 1
#define LSI_GATHER_CASE(CH)                                                  \
  case CH:                                                                   \
    if (max_dy >= 0) {                                                       \
      gather_bwd_coords_kernel<CH, true>                                     \
          <<<blocks, kThreads, 0, st>>>(LSI_GATHER_BWD_ARGS);                \
    } else {                                                                 \
      gather_bwd_coords_kernel<CH, false>                                    \
          <<<blocks, kThreads, 0, st>>>(LSI_GATHER_BWD_ARGS);                \
    }                                                                        \
    break;
    LSI_GATHER_CASE(1)
    LSI_GATHER_CASE(2)
    LSI_GATHER_CASE(3)
    LSI_GATHER_CASE(4)
    LSI_GATHER_CASE(5)
    LSI_GATHER_CASE(6)
    LSI_GATHER_CASE(7)
    LSI_GATHER_CASE(8)
#undef LSI_GATHER_CASE
#undef LSI_GATHER_BWD_ARGS
  }
  return static_cast<int>(cudaGetLastError());
}
